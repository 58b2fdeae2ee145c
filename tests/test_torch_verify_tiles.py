"""K5's and K4's middle rows (a verify step's 33 to 144 rows) on the CPU:
the launch plans, the dispatch, and the order of sums against the plain
versions and the JAX package's Pallas kernels.

On the card `csrc/mid_matmul.cuh` (`mid_kernel`) runs every token of a tile
on wgmma's N against 128 weight rows a CTA, the contraction's 64-deep steps
split over a cluster whose fp32 parts meet in shared memory
(`test_torch_kernels.py` and `chip_smoke.py` hold K5's one launch and K4's
two to the plain versions there). Here:

- `lora.mid_plan` and both stages of `swiglu.mid_plan` store every output
  once and take every 16-deep step of the contraction once per token tile
  and column block, at the verify step's rows and each limit, over the
  registry's K5 shapes (TinyLlama's fused QKV and proj, the MLP's under
  --lora_mlp, phi-2's) and K4's, with clusters of at most 4 and at most
  227 KB of shared memory a CTA;
- the dispatch crosses paths at 32/33 (K5), 64/65 (K4) and MID_ROWS /
  MID_ROWS + 1 (K5 192, K4 144);
- an emulation of each kernel's order of sums (a rank's 64-deep steps in
  order, each four k16 products; the cluster's parts in rank order; K5: xin
  A^T summed over the whole cluster before it is rounded, acc + s * delta,
  s = 0, a separate xin; K4: both gates, h rounded to x's dtype, `inter`'s
  parts in rank order) agrees in fp32 with the plain version and with the
  Pallas kernel in interpret mode (atol 1e-5: the same exact products
  summed in another order). In bf16 K5's emulation meets the Pallas kernel
  to one bf16 rounding, and rounding each rank's part of xin A^T misses it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.ops.pallas import lora_kernel, swiglu_kernel
from dualhyp_tpu_torch.ops import lora, mid, swiglu

FP32_ATOL = 1e-5

# K5's shapes (O, D, rank): TinyLlama's fused QKV and proj, the MLP's under
# --lora_mlp, phi-2's QKV and dense; a ragged one
LORA_SHAPES = [(2560, 2048, 48), (2048, 2048, 16), (5632, 2048, 16), (2048, 5632, 16),
               (7680, 2560, 48), (2560, 2560, 16), (200, 264, 40)]
# K4's (d, inter): TinyLlama's; a ragged one
SWIGLU_SHAPES = [(2048, 5632), (256, 1000)]


def _taken(plan, rows, n, k):
    """(outputs stored, 16-deep steps taken) by the plan's CTAs as
    mid_kernel enumerates them: counts over (token, column) and over (token
    tile, column block, k16 step)."""
    blocks, cols = plan["col_blocks"], 64 * plan["wg"]
    k16 = -(-k // 16)
    stored = np.zeros((rows, blocks * cols), np.int32)
    taken = np.zeros((plan["tiles"], blocks, k16), np.int32)
    for block in range(plan["ctas"]):
        rank, unit = block % plan["cluster"], block // plan["cluster"]
        cb, tile = unit % blocks, unit // blocks
        m0 = tile * plan["tokens"]
        tokens = min(plan["tokens"], rows - m0)
        assert tokens > 0
        s0, s1 = plan["steps"][rank]
        assert s1 > s0  # every rank takes a step
        for step in range(s0, s1):  # a 64-deep step: four k16 steps, none past k
            taken[tile, cb, 4 * step:min(4 * step + 4, k16)] += 1
        c0, c1 = plan["columns"][rank]
        stored[m0:m0 + tokens, cb * cols + c0:cb * cols + c1] += 1
    return stored[:, :n], taken


def _check_plan(plan, rows, n, k):
    assert plan["tokens"] in mid.MID_TILES
    assert plan["tiles"] * plan["tokens"] >= rows > (plan["tiles"] - 1) * plan["tokens"]
    if rows <= mid.MID_TILES[-1]:
        assert plan["tiles"] == 1  # up to 144 rows every token on N: the weight read once
    assert plan["cluster"] in mid.CLUSTERS and plan["cluster"] <= 4
    assert plan["ctas"] == plan["col_blocks"] * plan["tiles"] * plan["cluster"]
    assert plan["smem"] <= 227 * 1024
    stored, taken = _taken(plan, rows, n, k)
    assert (stored == 1).all() and (taken == 1).all()


@pytest.mark.parametrize("rows", sorted({33, 36, 72, 144, 145, lora.MID_ROWS}))
@pytest.mark.parametrize("o,d,r", LORA_SHAPES)
@pytest.mark.parametrize("s,separate", [(1.0, False), (0.5, True), (0.0, False)])
def test_lora_mid_plan_takes_every_output_and_step_once(rows, o, d, r, s, separate):
    plan = lora.mid_plan(rows, o, d, r, s, separate)
    _check_plan(plan, rows, o, d)
    # a third warpgroup over A's rows unless s = 0, a producer warpgroup
    assert plan["threads"] == 128 * (plan["wg"] + (s != 0)) + 128
    # one wave: the card holds every CTA at once
    assert plan["ctas"] <= mid.fill(plan["cluster"])


@pytest.mark.parametrize("rows", sorted({65, 72, 144, swiglu.MID_ROWS}))
@pytest.mark.parametrize("d,inter", SWIGLU_SHAPES)
def test_swiglu_mid_plan_takes_every_output_and_step_once(rows, d, inter):
    plan = swiglu.mid_plan(rows, d, inter)
    _check_plan(plan["gate"], rows, inter, d)  # h = gate(x W1^T, x W2^T)
    _check_plan(plan["down"], rows, d, inter)  # out = h W3^T
    assert plan["gate"]["tokens"] == plan["down"]["tokens"] == plan["tokens"]
    # W1's and W2's groups and a producer warpgroup; W3's and one
    assert plan["gate"]["threads"] == 2 * 128 * plan["gate"]["wg"] + 128
    assert plan["down"]["threads"] == 128 * plan["down"]["wg"] + 128


def test_mid_plans_at_the_verify_steps_shapes():
    # clusters of at most 4 (eight ran slower on the card): the fused QKV's
    # 20 column blocks x 4, proj's 16 x 4; K4's gate 88 x 1 (64 rows of W1
    # and W2 a CTA), its down launch 16 x 4, a programmatic dependent of the
    # gate above 72 rows
    got = {(o, r): (lora.mid_plan(144, o, 2048, r)["cluster"],
                    lora.mid_plan(144, o, 2048, r)["ctas"])
           for o, r in [(2560, 48), (2048, 16)]}
    assert got == {(2560, 48): (4, 80), (2048, 16): (4, 64)}
    plan = swiglu.mid_plan(144, 2048, 5632)
    assert (plan["gate"]["cluster"], plan["gate"]["ctas"]) == (1, 88)
    assert (plan["down"]["cluster"], plan["down"]["ctas"]) == (4, 64)
    assert plan["pdl"] and not swiglu.mid_plan(72, 2048, 5632)["pdl"]
    assert [lora.mid_plan(rows, 2560, 2048, 48)["tokens"] for rows in (33, 36, 72, 144)] == [
        48, 48, 72, 144]
    assert max(mid.CLUSTERS) == 4


def test_dispatch_crosses_paths_at_its_row_limits():
    assert lora.DECODE_ROWS == 32 and swiglu.DECODE_ROWS == 64
    # a verify step's 16 slots x 9 on both; K5's kernel beat the wgmma pair
    # to 192 rows (two token tiles), K4's path lost to the row tiles above 144
    assert (lora.MID_ROWS, swiglu.MID_ROWS) == (192, 144)
    assert lora.mid_plan(lora.MID_ROWS, 2560, 2048, 48)["tiles"] == 2
    assert [lora.path_of(r) for r in (32, 33, lora.MID_ROWS, lora.MID_ROWS + 1)] == [
        "decode", "mid", "mid", "wgmma"]
    assert [swiglu.path_of(r) for r in (64, 65, swiglu.MID_ROWS, swiglu.MID_ROWS + 1)] == [
        "decode", "mid", "mid", "rows"]
    for rows in (32, lora.MID_ROWS + 1):
        with pytest.raises(ValueError):
            lora.mid_plan(rows, 2560, 2048, 48)
    for rows in (64, swiglu.MID_ROWS + 1):
        with pytest.raises(ValueError):
            swiglu.mid_plan(rows, 2048, 5632)
    with pytest.raises(ValueError):
        lora.mid_plan(72, 2560, 2044, 48)  # D not a multiple of 8


# ---- the kernels' order of sums, emulated -----------------------------------

def _rank_parts(x, w, plan):
    """Each cluster rank's fp32 part of x W^T over its 64-deep steps, each
    step's four k16 products summed in turn (as mid_kernel's wgmma
    sequence adds them), zeros past k."""
    k = x.shape[1]
    pad = -k % 64
    x, w = (torch.nn.functional.pad(t, (0, pad)) for t in (x, w))
    parts = []
    for s0, s1 in plan["steps"]:
        acc = torch.zeros((x.shape[0], w.shape[0]))
        for step in range(s0, s1):
            for kk in range(4):
                ks = slice(64 * step + 16 * kk, 64 * step + 16 * kk + 16)
                acc += x[:, ks] @ w[:, ks].t()
        parts.append(acc)
    return parts


def _in_rank_order(parts):
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total


def lora_mid_emulation(x, w, a, b, s, xin=None, round_per_rank=False):
    """K5's middle kernel in fp32 (values of x's dtype), in its order: each
    rank's parts of x W^T and of xin A^T; the ranks' parts of xin A^T added
    in rank order, then rounded to x's dtype (`round_per_rank`: each part
    rounded first, a different function); the base parts in rank order,
    plus s times h B^T (exact products summed in rank-index order), rounded
    once."""
    dtype = x.dtype
    x, w, a, b = (t.to(dtype).float() for t in (x, w, a, b))
    xin = x if xin is None else xin.to(dtype).float()
    rows, d = x.shape
    plan = lora.mid_plan(rows, w.shape[0], d, a.shape[0], s, xin is not x)
    base = _in_rank_order(_rank_parts(x, w, plan))
    if s == 0:
        return base.to(dtype)
    hparts = _rank_parts(xin, a, plan)
    if round_per_rank:
        hparts = [p.to(dtype).float() for p in hparts]
    h = _in_rank_order(hparts).to(dtype).float()
    delta = torch.zeros_like(base)
    for j in range(a.shape[0]):
        delta += h[:, j:j + 1] * b[:, j]
    return (base + s * delta).to(dtype)


def swiglu_mid_emulation(x, w1, w2, w3, gate, round_h=True):
    """K4's middle path in fp32 (values of x's dtype), in its order: the
    gate launch's rank parts of x W1^T and x W2^T each added in rank order,
    then gated and rounded to x's dtype (`round_h` False: kept in fp32, a
    different function); the down launch's rank parts of h W3^T over
    `inter` added in rank order, rounded once."""
    dtype = x.dtype
    x, w1, w2, w3 = (t.to(dtype).float() for t in (x, w1, w2, w3))
    plan = swiglu.mid_plan(x.shape[0], x.shape[1], w1.shape[0])
    a = _in_rank_order(_rank_parts(x, w1, plan["gate"]))
    b = _in_rank_order(_rank_parts(x, w2, plan["gate"]))
    act = torch.nn.functional.silu(a) if gate == "silu" else swiglu._gelu_tanh(a)
    h = act * b
    if round_h:
        h = h.to(dtype).float()
    return _in_rank_order(_rank_parts(h, w3, plan["down"])).to(dtype)


def _lora_inputs(rng, rows, r, separate, o=200, d=264):
    x = rng.normal(size=(rows, d)).astype(np.float32)
    xin = rng.normal(size=(rows, d)).astype(np.float32) if separate else None
    w = rng.normal(size=(o, d)).astype(np.float32) * 0.05
    a = rng.normal(size=(r, d)).astype(np.float32) * 0.1
    b = rng.normal(size=(o, r)).astype(np.float32) * 0.1
    return x, xin, w, a, b


def _jax_lora(x, xin, w, a, b, s, dtype=jnp.float32):
    return np.asarray(lora_kernel.lora_linear(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(a), jnp.asarray(b), s,
        xin=None if xin is None else jnp.asarray(xin, dtype)), np.float32)


@pytest.mark.parametrize("rows,r,s,separate", [(36, 40, 2.0, False), (72, 16, 0.75, True),
                                               (36, 40, 0.0, False)])
def test_lora_mid_order_matches_plain_and_pallas(rng, rows, r, s, separate):
    x, xin, w, a, b = _lora_inputs(rng, rows, r, separate)
    # D = 264: five 64-deep steps over four ranks, the last one ragged
    assert lora.mid_plan(rows, 200, 264, r, s, separate)["cluster"] == 4
    t = [None if v is None else torch.from_numpy(v) for v in (x, xin, w, a, b)]
    got = lora_mid_emulation(t[0], t[2], t[3], t[4], s, t[1])
    plain = lora.lora_linear_plain(t[0], t[2], t[3], t[4], s, t[1])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=FP32_ATOL)
    np.testing.assert_allclose(got.numpy(), _jax_lora(x, xin, w, a, b, s), rtol=0,
                               atol=FP32_ATOL)


def test_lora_mid_rounds_the_rank_tile_after_the_cluster_sum(rng):
    """bf16: xin A^T rounded once after the sum over the whole cluster
    meets the Pallas kernel to one bf16 rounding of the output; rounding
    each rank's part first is a different function, and misses it."""
    x, xin, w, a, b = _lora_inputs(rng, 36, 48, True)
    w *= 0.01  # the rank branch dominates the output
    want = _jax_lora(x, xin, w, a, b, 2.0, jnp.bfloat16)
    t = [torch.from_numpy(v) for v in (x, xin, w, a, b)]
    tx, txin, tw = (v.to(torch.bfloat16) for v in t[:3])

    def err_ulps(got):
        got = got.float().numpy()
        ulp = np.maximum(np.abs(want), 1e-3) * 2.0 ** -8
        return float(np.max(np.abs(got - want) / ulp)), float(np.mean(got != want))

    once = err_ulps(lora_mid_emulation(tx, tw, t[3], t[4], 2.0, txin))
    per_rank = err_ulps(lora_mid_emulation(tx, tw, t[3], t[4], 2.0, txin, round_per_rank=True))
    assert once[0] <= 1.0 and once[1] < 0.02, once
    assert per_rank[0] > 1.0 and per_rank[1] > 0.1, per_rank


@pytest.mark.parametrize("rows,gate", [(72, "silu"), (100, "gelu")])
def test_swiglu_mid_order_matches_plain_and_pallas(rng, rows, gate):
    d, inter = 128, 200
    x = rng.normal(size=(rows, d)).astype(np.float32)
    w1, w2 = (rng.normal(size=(inter, d)).astype(np.float32) * 0.1 for _ in range(2))
    w3 = rng.normal(size=(d, inter)).astype(np.float32) * 0.1
    plan = swiglu.mid_plan(rows, d, inter)
    assert (plan["gate"]["cluster"], plan["down"]["cluster"]) == (2, 4)  # both split
    t = [torch.from_numpy(v) for v in (x, w1, w2, w3)]
    got = swiglu_mid_emulation(*t, gate)
    plain = swiglu.swiglu_mlp_plain(*t, gate)
    want = np.asarray(swiglu_kernel.swiglu_mlp(*(jnp.asarray(v) for v in (x, w1, w2, w3)),
                                               gate))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=FP32_ATOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_ATOL)


def test_swiglu_mid_rounds_h_to_the_input_dtype(rng):
    """bf16: h rounded to bf16 between the launches, as the plain version
    (and the Pallas kernel) round it: the output meets the plain version's
    to one bf16 rounding of the largest output on nearly every element;
    h kept in fp32 is a different function, and misses it."""
    d, inter = 128, 200
    x = torch.from_numpy(rng.normal(size=(72, d)).astype(np.float32)).to(torch.bfloat16)
    w1, w2 = (torch.from_numpy(rng.normal(size=(inter, d)).astype(np.float32) * 0.1)
              .to(torch.bfloat16) for _ in range(2))
    w3 = torch.from_numpy(rng.normal(size=(d, inter)).astype(np.float32) * 0.1).to(
        torch.bfloat16)
    want = swiglu.swiglu_mlp_plain(x, w1, w2, w3, "silu").float()
    ulp = float(want.abs().max()) * 2.0 ** -8

    def err(got):
        got = got.float()
        return float((got - want).abs().max()) / ulp, float((got != want).float().mean())

    rounded = err(swiglu_mid_emulation(x, w1, w2, w3, "silu"))
    in_fp32 = err(swiglu_mid_emulation(x, w1, w2, w3, "silu", round_h=False))
    assert rounded[0] <= 1.0 and rounded[1] < 0.02, rounded
    assert in_fp32[0] > 1.0 and in_fp32[1] > 0.1, in_fp32
