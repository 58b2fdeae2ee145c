"""K1, K4, L1, K8 and L2 at the edges of their Hopper kernels' tiles, on the CPU.

On the card the wgmma/TMA kernels (`csrc/flash_attention.cu`,
`csrc/flash_attention_bwd.cu`, `csrc/swiglu.cu`, `csrc/int4_matmul.cu`,
`csrc/grouped_matmul.cu`) are held to the plain versions
(`test_torch_kernels.py`, `chip_smoke.py`). Here the plain versions are held
to the JAX package's Pallas kernels in interpret mode at the shapes where
the kernels change path or tile: K4 on both sides of its decode path (at
most `swiglu.DECODE_ROWS` rows, operands swapped) and a ragged intermediate
size (the JAX package's jnp path there), K1's O and row logsumexp L at head
sizes 64 and 128 and GQA ratios 1 and 4; K1's backward at T = 256, two of
its 128-key blocks (and four 64-row query tiles), at head sizes 64 and 128
and GQA ratios 1 and 4; L1's forward O and logsumexp at head size 128 and
T = 256 against the splash kernel itself; K8 (`q4_matmul`) on both sides of
its decode tile (16 rows) and of its 128-token tile, at an N that
is not a multiple of its 128-row weight tile, at one group (K = 128) and at
group counts that do not divide its ring (three groups); L2's forward and
lhs gradient against megablox `gmm` and its VJP with groups of 127, 128 and
129 rows around its 128-row tile, a 5-row group between two large ones, an
empty last group and K = 40 (ragged against its 64-deep stages); and the
wrappers' copies of an input TMA cannot read.

Tolerances: fp32 on both sides, the same arithmetic summed in another order
(atol 1e-5; 1e-4 for L, a log of sums over up to 256 keys, and for the
backward's gradients, sums of up to 4 x 256 terms of unit-normal size; K8
2e-4 as `test_torch_quant.py` holds it, sums of up to 1280 products of
nibbles and unit-normal x scaled by ~0.01).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas.ops.tpu import megablox

from dualhyp_tpu.ops import quant as jquant
from dualhyp_tpu.ops.pallas import flash_attention, flash_vjp, int4_kernel, swiglu_kernel
from dualhyp_tpu_torch.ops import attention, gmm, int4, splash, swiglu


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _weights(rng, d, inter):
    w1, w2 = (rng.normal(size=(inter, d)).astype(np.float32) * 0.1 for _ in range(2))
    return w1, w2, rng.normal(size=(d, inter)).astype(np.float32) * 0.1


@pytest.mark.parametrize("rows", [1, 8, 64, 65, 130])
@pytest.mark.parametrize("gate", ["silu", "gelu"])
def test_swiglu_plain_matches_pallas_across_the_decode_edge(rng, rows, gate):
    assert swiglu.DECODE_ROWS == 64
    x = rng.normal(size=(rows, 64)).astype(np.float32)
    args = (x, *_weights(rng, 64, 256))
    want = swiglu_kernel.swiglu_mlp(*(jnp.asarray(a) for a in args), gate)
    _close(swiglu.swiglu_mlp(*(torch.from_numpy(a) for a in args), gate=gate), want)


@pytest.mark.parametrize("rows", [8, 65])
def test_swiglu_plain_matches_jax_at_a_ragged_inter(rng, rows):
    # inter 200: a partial last tile of W3's contraction on the card; the
    # JAX package takes its jnp path (200 is not a multiple of its block)
    x = rng.normal(size=(rows, 64)).astype(np.float32)
    args = (x, *_weights(rng, 64, 200))
    want = swiglu_kernel.swiglu_mlp(*(jnp.asarray(a) for a in args), "silu")
    _close(swiglu.swiglu_mlp(*(torch.from_numpy(a) for a in args)), want)


@pytest.mark.parametrize("d,t", [(64, 128), (64, 256), (128, 128)])
@pytest.mark.parametrize("q_per_kv", [1, 4])
def test_flash_forward_plain_matches_pallas_o_and_lse(rng, d, t, q_per_kv):
    q = rng.normal(size=(1, 4, t, d)).astype(np.float32)
    k, v = (rng.normal(size=(1, 4 // q_per_kv, t, d)).astype(np.float32) for _ in range(2))
    scale = float(d) ** -0.5
    want_o, (_, _, _, _, want_lse) = flash_vjp._forward(
        *(jnp.asarray(a) for a in (q, k, v)), scale)
    o, lse = attention.causal_attention_plain_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), scale)
    _close(o, want_o)
    _close(lse, np.asarray(want_lse)[..., 0], atol=1e-4)


def test_swiglu_wrapper_copies_only_an_unaligned_input():
    flat = torch.arange(1 + 4 * 64, dtype=torch.bfloat16)
    unaligned = flat[1:].view(4, 64)
    assert unaligned.data_ptr() % 16
    copy = swiglu._aligned(unaligned)
    assert copy.data_ptr() % 16 == 0 and copy.is_contiguous()
    assert torch.equal(copy, unaligned)
    aligned = flat[:64 * 4].view(4, 64)
    assert swiglu._aligned(aligned) is aligned


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("q_per_kv", [1, 4])
def test_flash_backward_plain_matches_pallas_across_key_blocks(rng, d, q_per_kv):
    # T = 256: the Pallas `_bwd_kernel` (interpret mode) against the plain
    # backward the card's kernel is held to, over two 128-key blocks
    t = 256
    q, do = (rng.normal(size=(1, 4, t, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(1, 4 // q_per_kv, t, d)).astype(np.float32) for _ in range(2))
    scale = float(d) ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: flash_vjp.flash_attention(a, b, c, scale),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = attention.causal_attention_plain_lse(tq, tk, tv, scale)
    got = attention.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale)
    for x, w in zip(got, want):
        _close(x, w, atol=1e-4)


@pytest.mark.parametrize("q_per_kv", [1, 4])
def test_splash_forward_plain_matches_the_splash_kernel_o_and_lse(rng, q_per_kv):
    # the splash kernel as the JAX package builds it (`_splash_kernel`'s
    # mask and blocks), with its logsumexp residual kept, on q already
    # multiplied by the scale (the JAX wrapper's q_hat; the kernel's scale 1)
    from jax.experimental.pallas.ops.tpu import splash_attention as sa

    t, d, g = 256, 128, 4 // q_per_kv
    q_hat = rng.normal(size=(1, 4, t, d)).astype(np.float32) * np.float32(d ** -0.5)
    k, v = (rng.normal(size=(1, g, t, d)).astype(np.float32) for _ in range(2))
    mask = sa.MultiHeadMask([sa.CausalMask((t, t)) for _ in range(q_per_kv)])
    blocks = sa.BlockSizes(**{f: min(512, t) for f in (
        "block_q", "block_kv", "block_kv_compute", "block_q_dkv", "block_kv_dkv",
        "block_kv_dkv_compute", "block_q_dq", "block_kv_dq")})
    kernel = sa.make_splash_mqa_single_device(mask, block_sizes=blocks, save_residuals=True,
                                              interpret=True)
    assert flash_attention._MIN_SEQ == 128
    want_o, (want_lse,) = jax.vmap(jax.vmap(kernel))(
        jnp.asarray(q_hat.reshape(1, g, q_per_kv, t, d)), jnp.asarray(k), jnp.asarray(v))
    o, lse = splash.splash_fwd_plain(*(torch.from_numpy(a) for a in (q_hat, k, v)), 1.0)
    _close(o, np.asarray(want_o).reshape(1, 4, t, d))
    _close(lse, np.asarray(want_lse).reshape(1, 4, t), atol=1e-4)


def _views():
    flat = torch.arange(1 + 2 * 4 * 16 * 64, dtype=torch.float32).bfloat16()
    wide = torch.zeros(2, 4, 16, 68, dtype=torch.bfloat16)
    return {"unaligned_base": flat[1:].view(2, 4, 16, 64),
            "token_stride_of_68": wide[..., :64],
            "aligned": flat[:-1].view(2, 4, 16, 64)}


@pytest.mark.parametrize("case", ["unaligned_base", "token_stride_of_68", "aligned"])
def test_splash_wrapper_copies_only_an_input_tma_cannot_read(case):
    # TMA needs a 16-byte aligned base and strides of multiples of 16 bytes;
    # a stride of 68 bf16 (136 bytes) fails, as does a base 2 bytes in
    x = _views()[case]
    got = splash._tma_readable(x)
    assert torch.equal(got, x)
    assert got.data_ptr() % 16 == 0 and attention._aligned_rows(got)
    if case == "aligned":
        assert got is x
    else:
        assert got.data_ptr() != x.data_ptr() and got.is_contiguous()


@pytest.mark.parametrize("rows,n,k", [
    (16, 200, 640), (17, 200, 640),  # the decode tile's edge
    (127, 200, 640), (128, 200, 640), (129, 200, 640),  # the 128-token tile
    (256, 200, 640), (257, 200, 640),  # two token tiles; a third begun
    (65, 200, 128), (129, 136, 1280)])  # one group; ten groups (ring of three)
def test_q4_matmul_plain_matches_pallas_at_the_tile_edges(rng, rows, n, k):
    w = rng.normal(size=(n, k)).astype(np.float32) * 0.05
    x = rng.normal(size=(rows, k)).astype(np.float32)
    packed, scale = jquant.quantize_weight_int4(jnp.asarray(w))
    want = int4_kernel.q4_matmul(jnp.asarray(x), packed, scale)
    got = int4.q4_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(packed)),
                         torch.from_numpy(np.asarray(scale)))
    _close(got, want, atol=2e-4)
    groups = k // int4.KERNEL_GROUP
    path = int4.path_of(rows, n, k)
    if path != "wgmma":  # the decode and middle kernels' ranks take every group once
        plan = (int4.decode_plan if path == "decode" else int4.mid_plan)(rows, n, k)
        assert [g for lo, hi in plan["groups"] for g in range(lo, hi)] == list(range(groups))
    else:
        splits, per = int4.split_k(rows, n, groups)
        assert splits * per >= groups > (splits - 1) * per


def test_q4_tiles_change_at_the_decode_rows():
    # the rows where csrc/int4_matmul.cu changes path (`int4.path_of`: m <=
    # 16 the decode kernel, 128 columns a CTA; to MID_ROWS the middle
    # kernel, 128 columns by a token tile; above, wgmma, 128 x 128, whose
    # K split `split_k` plans from these tiles)
    assert [int4.tile(r)[:2] for r in (16, 17, 64, 65)] == [(16, 128), (128, 128),
                                                              (128, 128), (128, 128)]
    assert [int4.path_of(r, 200, 640) for r in (16, 17, 64, 65, int4.MID_ROWS + 1)] == [
        "decode", "mid", "mid", "mid", "wgmma"]


# L2's row groups at the edges of its 128-row tile (m a multiple of 128, the
# tile megablox is given, so its tiles straddle the groups as the card's do)
GMM_EDGE_GROUPS = {
    "bm_minus_plus": [127, 128, 129],
    "small_between_large": [200, 5, 179],
    "empty_last": [129, 127, 0],
}


def _megablox(lhs, w, sizes):
    return megablox.gmm(lhs, w, jnp.asarray(sizes), preferred_element_type=jnp.float32,
                        tiling=(128, lhs.shape[1], w.shape[1]), transpose_rhs=True,
                        interpret=True)


@pytest.mark.parametrize("case", list(GMM_EDGE_GROUPS))
def test_grouped_matmul_plain_matches_megablox_at_the_tile_edges(rng, case):
    sizes = np.asarray(GMM_EDGE_GROUPS[case], np.int32)
    m, n, k = int(sizes.sum()), 24, 40
    lhs = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(len(sizes), n, k)).astype(np.float32)  # (E, N, K)
    want = _megablox(jnp.asarray(lhs), jnp.asarray(w), sizes)
    _close(gmm.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(w),
                              torch.from_numpy(sizes)), want)


@pytest.mark.parametrize("case", list(GMM_EDGE_GROUPS))
def test_grouped_matmul_dlhs_plain_matches_megablox_vjp_at_the_tile_edges(rng, case):
    # the lhs gradient's output columns are K = 40, its contraction N = 24
    sizes = np.asarray(GMM_EDGE_GROUPS[case], np.int32)
    m, n, k = int(sizes.sum()), 24, 40
    lhs = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(len(sizes), n, k)).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: _megablox(a, jnp.asarray(w), sizes), jnp.asarray(lhs))
    (want,) = vjp(jnp.asarray(g))
    _close(gmm.grouped_matmul_dlhs(torch.from_numpy(g), torch.from_numpy(w),
                                   torch.from_numpy(sizes)), want)
