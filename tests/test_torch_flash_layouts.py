"""K1's forward and backward instances on the CPU: the layouts the wrappers
plan, the rows K1's backward reads in place at head size 100, and the
forward's order of arithmetic.

On the card `csrc/flash_attention.cu` runs K1's forward at 80 and 96 with
the columns past 64 in a narrow box, with two warpgroups (80 to 128) the
next 64-key tile's Q K^T beside this tile's softmax, and at every head
size S scaled inside the FMA that feeds 2^x, and
`csrc/flash_attention_bwd.cu` reads q, k, v and dO at 100 by cp.async,
8 bytes a copy (`test_torch_kernels.py` and `chip_smoke.py` hold them to
the plain versions there). Here:

- `attention.fwd_layout` gives every registry head size its instance
  within 227 KB of shared memory a block, and `bwd_layout(100)` the
  in-place instance;
- the rows the backward takes at 100 (`_aligned_rows(x, 8)`): the fused
  QKV projection's views that `split_heads` makes, K3's outputs and a
  transposed gradient pass; a view off by 4 bytes or with a 102-element
  row stride does not, and the views TMA could not read are among those
  that pass;
- an emulation of the forward's order (64 rows a warpgroup,
  64-key tiles up to the diagonal, the running max in base 2 scaled after
  the tile's max, P = 2^(fma(S, scale log2 e, -m)) with subnormal results
  flushed, rounded to bf16 before P V, O rescaled before each tile's P V)
  agrees with `flash_vjp`'s `_fwd_kernel` in interpret mode and with the
  plain version at the tolerance the card holds K1 to.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.ops.pallas import flash_vjp
from dualhyp_tpu_torch import registry
from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.models.gpt import split_heads
from dualhyp_tpu_torch.ops import attention

# chip_smoke.py's TOLERANCES["flash_attention_fwd"] and LSE_TOL
O_TOL = (1e-2, 2.0 ** -6)
LSE_TOL = (1e-4, 1e-5)
SMEM = 232448  # a block's most dynamic shared memory on the H100 (227 KB)

# (instance, whole 64-column boxes, narrow tail, consumer warpgroups)
FWD_LAYOUTS = {32: (32, 1, 0, 1), 64: (64, 1, 0, 1), 80: (80, 1, 16, 2), 96: (96, 1, 32, 2),
               100: (104, 2, 0, 2), 128: (128, 2, 0, 2), 256: (256, 4, 0, 1)}


@pytest.mark.parametrize("d", attention.FLASH_HEAD_SIZES)
def test_k1_forward_layout_of_each_head_size(d):
    lay = attention.fwd_layout(d)
    assert (lay["instance"], lay["boxes"], lay["tail"], lay["warpgroups"]) == FWD_LAYOUTS[d]
    # every column in a whole box or the narrow one: none past D at 80 and 96
    assert lay["boxes"] * 64 + lay["tail"] >= lay["instance"] > (lay["boxes"] - 1) * 64
    assert lay["tail"] in (0, 16, 32) and (lay["tail"] == 0 or lay["boxes"] * 64 + lay[
        "tail"] == lay["instance"])
    # the two-warpgroup instances overlap Q K^T with the softmax, and hold
    # a tile from its Q K^T to its P V: four stages; the others as before
    assert lay["overlap"] == (lay["warpgroups"] == 2)
    assert lay["stages"] == (4 if lay["overlap"] else 2)
    assert lay["keys"] == 64 and lay["smem"] <= SMEM
    with pytest.raises(ValueError):
        attention.fwd_layout(48)


def test_every_registry_head_size_has_forward_and_backward_instances():
    sizes = {registry.config_from_name(n).head_size for n in registry.available_configs()}
    for d in sizes:
        fwd, bwd = attention.fwd_layout(d), attention.bwd_layout(d)
        assert fwd["instance"] % 8 == 0  # TMA's rows: a whole number of 16 bytes
        assert bwd["loads"] == ("cp.async" if d % 8 else "tma")
        assert bwd["instance"] == d


def test_k1_backward_reads_head_size_100_in_place():
    lay = attention.bwd_layout(100)
    assert lay == dict(instance=100, warpgroups=1, keys=64, boxes=2, tail=0,
                       producer_warpgroup=True, loads="cp.async", merged_dq=False, parts=1)
    assert attention.IN_PLACE == (100,) and attention.padded_head_size(100) == 104


def _open_llama_views(b=2, t=9, g=32):
    """q, k, v of open_llama_3b's fused QKV projection (32 heads of 100; a
    group of 4 heads with g = 8) as `split_heads` cuts them."""
    cfg = GPTConfig(n_embd=3200, n_head=32, n_query_groups=g, intermediate_size=256,
                    mlp_class="LLaMAMLP")
    q5, k, v = split_heads(cfg, torch.zeros(b, t, cfg.qkv_out_dim, dtype=torch.bfloat16))
    return q5.reshape(b, 32, t, 100), k, v


@pytest.mark.parametrize("g", [32, 8])
def test_backward_at_100_takes_the_models_rows(g):
    q, k, v = _open_llama_views(g=g)
    k3 = torch.zeros(2, 32, 9, 100, dtype=torch.bfloat16)  # K3 writes contiguous rows
    do = torch.zeros(2, 9, 3200, dtype=torch.bfloat16).view(2, 9, 32, 100).transpose(1, 2)
    views = (q, k, v, k3, do)
    assert all(attention._aligned_rows(x, 8) for x in views)
    # the views TMA cannot read: a 600-byte group stride (MHA), or a base
    # 8 bytes past 16 (groups of 4 heads: v starts 500 elements in)
    assert not attention._aligned_rows(v)


def test_backward_at_100_refuses_misaligned_rows():
    rows = torch.zeros(2, 4, 9, 104, dtype=torch.bfloat16)
    assert attention._aligned_rows(rows[..., 4:104], 8)  # 8 bytes in: fine
    assert not attention._aligned_rows(rows[..., 2:102], 8)  # 4 bytes in
    wide = torch.zeros(2, 4, 9, 102, dtype=torch.bfloat16)
    assert not attention._aligned_rows(wide[..., :100], 8)  # a 204-byte row
    assert not attention._aligned_rows(rows.transpose(-1, -2)[..., :100], 8)  # columns strided


def forward_emulation(q, k, v, scale):
    """K1's forward in the card's order: each warpgroup's 64
    query rows walk the 64-key tiles up to the diagonal; a tile's S (fp32,
    -inf where masked) gives the new running max m = max(m, max(S) scale
    log2 e), alpha = 2^(m_old - m), l = alpha l + sum P with P =
    2^(fma(S, scale log2 e, -m)) (the FMA's one rounding; subnormal results
    flushed, as the SFU's ex2.approx.ftz), O = alpha O + bf16(P) V; then O / l
    rounded to bf16 and L = m / log2 e + log l. q (B, Hq, T, D), k, v (B,
    G, T, D) bf16."""
    b, hq, t, d = q.shape
    qpk = hq // k.shape[1]
    log2e = 1.4426950408889634
    scale2 = torch.tensor(scale * log2e, dtype=torch.float32)
    kf = k.float().repeat_interleave(qpk, dim=1)
    vf = v.float().repeat_interleave(qpk, dim=1)
    qf = q.float()
    out = torch.empty(b, hq, t, d, dtype=q.dtype)
    lse = torch.empty(b, hq, t)
    for first in range(0, t, 64):
        rows = torch.arange(first, min(first + 64, t))
        m = torch.full((b, hq, len(rows)), -math.inf)
        l = torch.zeros(b, hq, len(rows))
        o = torch.zeros(b, hq, len(rows), d)
        for k0 in range(0, min(t, first + 64), 64):
            keys = torch.arange(k0, min(k0 + 64, t))
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            s = s.masked_fill(keys[None, :] > rows[:, None], -math.inf)
            m_new = torch.maximum(m, s.amax(-1) * scale2)
            base = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
            alpha = torch.exp2(m - base)
            arg = (s.double() * scale2.double() - base.double()[..., None]).float()
            p = torch.exp2(arg)
            p = torch.where(p < 2.0 ** -126, torch.zeros_like(p), p)
            l = alpha * l + p.sum(-1)
            o = alpha[..., None] * o + p.bfloat16().float() @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = (o / l[..., None]).to(q.dtype)
        lse[:, :, rows] = m / log2e + torch.log(l)
    return out, lse


def _close(got, want, tol):
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <= tol[0] + tol[1] * want.abs()).all()), \
        float((got - want).abs().max())


@pytest.mark.parametrize("d,hq,g", [(64, 4, 1), (80, 4, 2), (96, 4, 4), (128, 4, 2)])
def test_forward_order_matches_pallas_and_plain(d, hq, g):
    """At T = 256 (four key tiles, two 128-row blocks) against the Pallas
    kernel in interpret mode; at a ragged T = 200 against the plain version
    (the JAX package takes XLA there)."""
    rng = np.random.default_rng(d)
    scale = d ** -0.5
    for t in (256, 200):
        q, k, v = (torch.from_numpy(rng.normal(size=(1, h, t, d)).astype(np.float32))
                   .bfloat16() for h in (hq, g, g))
        got_o, got_lse = forward_emulation(q, k, v, scale)
        if t == 256:
            out, res = flash_vjp._forward(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                                          scale)
            want_o = torch.from_numpy(np.array(out))
            want_lse = torch.from_numpy(np.array(res[4])[..., 0])
        else:
            want_o, want_lse = attention.causal_attention_plain_lse(q, k, v, scale)
        _close(got_o, want_o, O_TOL)
        _close(got_lse, want_lse, LSE_TOL)
