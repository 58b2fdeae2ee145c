"""K8's and K5's decode kernels (at most 16 and 32 rows) on the CPU: their launch
plans, and their order of sums against the plain versions and the JAX
package's Pallas kernels.

On the card `csrc/int4_matmul.cu` (`q4_decode_kernel`) and
`csrc/lora_linear.cu` (`lora_decode_kernel`) stream the weights into
mma.sync fragments in one launch a call, their CTAs in clusters that split
K (D) and add the parts in shared memory (`test_torch_kernels.py` and
`chip_smoke.py` hold them to the plain versions there). Here:

- `int4.decode_plan` and `lora.decode_plan` store every output column once
  and take every group (32-deep step of D) once, at every decode shape the
  int4 and fused slices launch and at the card tests' edge shapes, with
  clusters of at most 8 CTAs, at most 227 KB of shared memory a CTA and no
  split of K outside a cluster (nothing goes through device memory);
- a plain-PyTorch emulation of each kernel's order: x staged as the kernel
  stages it (K8: its k order permuted within a group to meet the nibbles),
  the A and B fragments of each mma.sync step read as the kernel reads
  them, each step's 16 products, the steps, the groups (scaled after their
  sum) and the cluster's parts added in the kernel's order; for K5 the rank
  tile xin A^T summed over all of D before it is rounded. It agrees with
  the plain version and with the Pallas kernel in interpret mode in fp32
  (atol 1e-5: the same exact products summed in another order). In bf16 it
  agrees with the Pallas kernel to one bf16 rounding, and an emulation that
  rounds each D slice's part of the rank tile instead misses it there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.ops import quant as jquant
from dualhyp_tpu.ops.pallas import int4_kernel, lora_kernel
from dualhyp_tpu_torch.ops import int4, lora

FP32_ATOL = 1e-5

# TinyLlama-1.1B's int4 linears at decode (N, K): qkv, attn.proj, fc_1 and
# fc_2, mlp.proj, lm_head; then the card tests' edge shapes
Q4_SLICE = [(2560, 2048), (2048, 2048), (5632, 2048), (2048, 5632), (32000, 2048)]
Q4_EDGES = [(100, 128), (100, 640), (320, 128), (320, 640), (256, 2048)]
# the fused slice's K5 calls (O, D, rank): QKV (three blocks of r = 16) and
# proj; then the card tests' edge shapes
LORA_SLICE = [(2560, 2048, 48), (2048, 2048, 16)]
LORA_EDGES = [(100, 64, 16), (2560, 256, 48), (200, 264, 16), (200, 264, 48), (520, 704, 64),
              (96, 256, 4)]


def _check_plan(plan, n, parts, rows):
    """Every output column stored by one CTA, every part of K taken by one
    rank, within the card's limits."""
    cluster = plan["cluster"]
    assert 1 <= cluster <= 8 and plan["ctas"] == plan["col_blocks"] * cluster
    assert plan["smem"] <= 227 * 1024
    assert plan["token_tiles"] * 8 >= rows > (plan["token_tiles"] - 1) * 8
    # the K split lives in the cluster: one part a rank, met in shared memory
    ranges = plan.get("groups", plan.get("steps"))
    assert len(ranges) == cluster
    taken = [p for lo, hi in ranges for p in range(lo, hi)]
    assert taken == list(range(parts)) and all(hi > lo for lo, hi in ranges)
    width = plan["columns"][-1][1]
    stored = [cb * width + c for cb in range(plan["col_blocks"])
              for lo, hi in plan["columns"] for c in range(lo, hi)]
    assert sorted(stored) == list(range(plan["col_blocks"] * width))
    assert plan["col_blocks"] * width >= n > (plan["col_blocks"] - 1) * width


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("n,k", Q4_SLICE + Q4_EDGES)
def test_q4_decode_plan_covers_every_column_and_group(rows, n, k):
    plan = int4.decode_plan(rows, n, k)
    _check_plan(plan, n, k // int4.KERNEL_GROUP, rows)
    assert plan["threads"] == 256


def test_q4_decode_plan_fills_the_card_at_the_slice_shapes():
    # clusters of 8 where the column blocks are few; lm_head's 250 blocks
    # take 2: 500 CTAs, all resident at once
    got = {(n, k): int4.decode_plan(8, n, k)["cluster"] for n, k in Q4_SLICE}
    assert got == {(2560, 2048): 8, (2048, 2048): 8, (5632, 2048): 8, (2048, 5632): 8,
                   (32000, 2048): 2}
    with pytest.raises(ValueError):
        int4.decode_plan(17, 256, 2048)


@pytest.mark.parametrize("rows", [1, 8, 16, 32])
@pytest.mark.parametrize("o,d,r", LORA_SLICE + LORA_EDGES)
@pytest.mark.parametrize("s,separate", [(1.0, False), (0.75, True), (0.0, False)])
def test_lora_decode_plan_covers_every_column_and_step(rows, o, d, r, s, separate):
    plan = lora.decode_plan(rows, o, d, r, s, separate)
    _check_plan(plan, o, -(-d // lora.DECODE_STEP), rows)
    # s = 0 skips the rank branch: no warps over A
    assert plan["rank_tiles"] == (0 if s == 0 else -(-r // 16))
    assert plan["threads"] == 32 * (8 + plan["rank_tiles"])


def test_lora_decode_rows_are_pinned():
    # the decode kernel's most rows, below which it beat the wgmma kernels
    # at every count measured
    assert lora.DECODE_ROWS == 32
    assert lora.decode_plan(8, 2560, 2048, 48)["cluster"] == 8
    assert lora.decode_plan(32, 2560, 2048, 48)["token_tiles"] == 4
    with pytest.raises(ValueError):
        lora.decode_plan(33, 2560, 2048, 48)


# ---- the kernels' order of sums, emulated -----------------------------------

# K8: x's 16-byte chunk 4 quad + i of a group (k 32 quad + 8 i + [0, 8)) is
# staged at chunk 4 i + quad, its elements in this order
Q4_ELEMENTS = [0, 4, 1, 5, 2, 6, 3, 7]


def _signed(nibble):
    return nibble - 16 * (nibble >= 8)


def _q4_fragments(x, packed):
    """The A (weights) and B (x) values of each mma.sync step of each group,
    as q4_decode_kernel's lanes hold them: A (n, groups, 8 steps, 16 k), B
    (rows, groups, 8 steps, 16 k), the 16 k of a step in mma.sync's order
    (lane quad q: k 2q, 2q + 1, then 2q + 8, 2q + 9)."""
    rows, k = x.shape
    n, groups = packed.shape[0], k // 128
    # lane (row, quad)'s 16 bytes of a group: words i = 0..3, little endian
    b = packed.to(torch.int64) & 0xFF
    words = b.reshape(n, groups, 4, 4, 4)  # (n, g, quad, word i, byte)
    words = sum(words[..., j] << (8 * j) for j in range(4))
    # x staged: chunk 4 quad + i at 4 i + quad, elements permuted
    xg = x.reshape(rows, groups, 4, 4, 8)  # (rows, g, quad, i, element)
    staged = xg[..., Q4_ELEMENTS].transpose(2, 3)  # (rows, g, i, quad, element)
    a_steps, b_steps = [], []
    for step in range(8):
        i, h = divmod(step, 2)
        a_k = torch.zeros((n, groups, 16))
        b_k = torch.zeros((rows, groups, 16))
        for q in range(4):
            w = words[:, :, q, i]
            # A: pair_k4(word >> 8h) at k (2q, 2q + 1), pair_k4(word >> 8h + 4)
            # at (2q + 8, 2q + 9); a pair is the word's bits 0-3 and 16-19
            for slot, shift in ((2 * q, 8 * h), (2 * q + 8, 8 * h + 4)):
                a_k[:, :, slot] = _signed((w >> shift) & 0xF).float()
                a_k[:, :, slot + 1] = _signed((w >> (shift + 16)) & 0xF).float()
            # B: the 16 bytes at chunk 4 i + quad, words (0, 1) at step 2i,
            # (2, 3) at step 2i + 1
            chunk = staged[:, :, i, q]
            b_k[:, :, 2 * q:2 * q + 2] = chunk[..., 4 * h:4 * h + 2]
            b_k[:, :, 2 * q + 8:2 * q + 10] = chunk[..., 4 * h + 2:4 * h + 4]
        a_steps.append(a_k)
        b_steps.append(b_k)
    return torch.stack(a_steps, 2), torch.stack(b_steps, 2)


def q4_decode_emulation(x, packed, scales):
    """K8's decode kernel in fp32, in its order: per group the 8 steps'
    sums (16 products each), scaled after the sum; per rank its groups in
    order; the ranks' parts added in rank order."""
    x = x.float()
    rows, k = x.shape
    plan = int4.decode_plan(rows, packed.shape[0], k)
    a, b = _q4_fragments(x, packed)
    out = None
    for g0, g1 in plan["groups"]:
        acc = torch.zeros((rows, packed.shape[0]))
        for g in range(g0, g1):
            part = torch.zeros_like(acc)
            for step in range(8):
                part += b[:, g, step] @ a[:, g, step].t()
            acc += part * scales[:, g]
        out = acc if out is None else out + acc
    return out


def lora_decode_emulation(x, w, a, b, s, xin=None, round_per_slice=False):
    """K5's decode kernel in fp32 (values of x's dtype), in its order: per
    32-deep step of D the two mma.sync steps (lane quad q: k 8q + 4h +
    [0, 2) at (2q, 2q + 1), + [2, 4) at (2q + 8, 2q + 9)); per rank its steps
    in order; the ranks' parts of xin A^T added in rank order, then rounded
    to x's dtype (`round_per_slice`: each part rounded first, a different
    function); the base parts in rank order, plus s times h B^T."""
    dtype = x.dtype  # w, a and b are cast to it, as lora_linear casts them
    x, w, a, b = (t.to(dtype).float() for t in (x, w, a, b))
    xin = x if xin is None else xin.float()
    rows, d = x.shape
    plan = lora.decode_plan(rows, w.shape[0], d, a.shape[0], s, xin is not x)
    steps = -(-d // 32)
    pad = steps * 32 - d
    xp, xinp, wp, ap = (torch.nn.functional.pad(t, (0, pad)) for t in (x, xin, w, a))
    order = [[32 * st + 8 * q + 4 * h + e for q in range(4) for e in (0, 1)]
             + [32 * st + 8 * q + 4 * h + 2 + e for q in range(4) for e in (0, 1)]
             for st in range(steps) for h in range(2)]
    base, h = None, None
    for k0, k1 in plan["steps"]:
        part = torch.zeros((rows, w.shape[0]))
        hpart = torch.zeros((rows, a.shape[0]))
        for ks in order[2 * k0:2 * k1]:
            part += xp[:, ks] @ wp[:, ks].t()
            hpart += xinp[:, ks] @ ap[:, ks].t()
        if round_per_slice:
            hpart = hpart.to(dtype).float()
        base = part if base is None else base + part
        h = hpart if h is None else h + hpart
    h = h.to(dtype).float()
    if s == 0:
        return base.to(dtype)
    return (base + s * (h @ b.t())).to(dtype)


@pytest.mark.parametrize("rows", [1, 8, 16])
def test_q4_decode_order_matches_plain_and_pallas(rng, rows):
    w = rng.normal(size=(320, 640)).astype(np.float32) * 0.05
    x = rng.normal(size=(rows, 640)).astype(np.float32)
    packed, scale = jquant.quantize_weight_int4(jnp.asarray(w))
    tp, ts = torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(scale))
    assert int4.decode_plan(rows, 320, 640)["cluster"] == 4  # five groups over four ranks
    got = q4_decode_emulation(torch.from_numpy(x), tp, ts)
    want = np.asarray(int4_kernel.q4_matmul(jnp.asarray(x), packed, scale))
    plain = int4.q4_matmul_plain(torch.from_numpy(x), tp, ts)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=FP32_ATOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_ATOL)


def _lora_inputs(rng, rows, r, separate, o=200, d=264):
    x = rng.normal(size=(rows, d)).astype(np.float32)
    xin = rng.normal(size=(rows, d)).astype(np.float32) if separate else None
    w = rng.normal(size=(o, d)).astype(np.float32) * 0.05
    # outputs of order 1 (the rank branch ~1.5 at r = 48): fp32 sums of
    # their size in another order stay within FP32_ATOL
    a = rng.normal(size=(r, d)).astype(np.float32) * 0.1
    b = rng.normal(size=(o, r)).astype(np.float32) * 0.1
    return x, xin, w, a, b


def _jax_lora(x, xin, w, a, b, s, dtype=jnp.float32):
    return np.asarray(lora_kernel.lora_linear(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(a), jnp.asarray(b), s,
        xin=None if xin is None else jnp.asarray(xin, dtype)), np.float32)


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("r", [16, 48])
@pytest.mark.parametrize("separate", [False, True])
def test_lora_decode_order_matches_plain_and_pallas(rng, rows, r, separate):
    x, xin, w, a, b = _lora_inputs(rng, rows, r, separate)
    s = 2.0
    assert lora.decode_plan(rows, 200, 264, r, s, separate)["cluster"] == 8  # nine steps
    t = [None if v is None else torch.from_numpy(v) for v in (x, xin, w, a, b)]
    got = lora_decode_emulation(t[0], t[2], t[3], t[4], s, t[1])
    plain = lora.lora_linear_plain(t[0], t[2], t[3], t[4], s, t[1])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=FP32_ATOL)
    np.testing.assert_allclose(got.numpy(), _jax_lora(x, xin, w, a, b, s), rtol=0,
                               atol=FP32_ATOL)


def test_lora_decode_order_at_a_zero_scale_is_the_base_product(rng):
    x, _, w, a, b = _lora_inputs(rng, 8, 48, False)
    t = [torch.from_numpy(v) for v in (x, w, a, b)]
    got = lora_decode_emulation(*t, 0.0)
    np.testing.assert_allclose(got.numpy(), _jax_lora(x, None, w, a, b, 0.0), rtol=0,
                               atol=FP32_ATOL)


def test_lora_decode_rounds_the_rank_tile_after_the_full_sum(rng):
    """bf16: the rank tile rounded once after the cluster's sum over all of
    D meets the Pallas kernel to one bf16 rounding of the output (fp32 sums
    in another order); rounding each D slice's part first is a different
    function, and misses it."""
    rows, r = 16, 48
    x, xin, w, a, b = _lora_inputs(rng, rows, r, True)
    w *= 0.01  # the rank branch dominates the output
    bf = torch.bfloat16
    want = _jax_lora(x, xin, w, a, b, 2.0, jnp.bfloat16)
    t = [torch.from_numpy(v) for v in (x, xin, w, a, b)]
    tx, txin, tw = (v.to(bf) for v in t[:3])

    def err_ulps(got):
        """Largest error in units of the output's bf16 spacing (2^-8 of
        its magnitude), and the share of outputs that differ at all."""
        got = got.float().numpy()
        ulp = np.maximum(np.abs(want), 1e-3) * 2.0 ** -8
        return float(np.max(np.abs(got - want) / ulp)), float(np.mean(got != want))

    once = err_ulps(lora_decode_emulation(tx, tw, t[3], t[4], 2.0, txin))
    per_slice = err_ulps(lora_decode_emulation(tx, tw, t[3], t[4], 2.0, txin,
                                               round_per_slice=True))
    assert once[0] <= 1.0 and once[1] < 0.02, once
    assert per_slice[0] > 1.0 and per_slice[1] > 0.1, per_slice
