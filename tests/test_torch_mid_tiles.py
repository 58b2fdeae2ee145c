"""K8's middle rows (17 to `int4.MID_ROWS`) and K1's backward layout on the
CPU: the launch plan, the order of sums against the plain version and the
JAX package's Pallas kernel, and the head sizes' instances.

On the card `csrc/int4_matmul.cu` (`q4_mid_kernel`) runs every token of a
tile on wgmma's N against 128 weight rows a CTA, the groups of K split over
a cluster whose fp32 parts meet in shared memory (`test_torch_kernels.py`
and `chip_smoke.py` hold it to the plain version there). Here:

- `int4.mid_plan` stores every output once and takes every group once per
  token tile, at the verify step's and the Whisper beam's rows and shapes,
  in one launch with clusters of at most 8 CTAs within 227 KB a CTA, and the
  dispatch crosses paths at 16/17 and MID_ROWS/MID_ROWS + 1;
- an emulation of the kernel's order (each group's 8 k16 steps in k order,
  the sum scaled after the group, a rank's groups in turn, the cluster's
  parts in rank order) agrees in fp32 with the plain version and with the
  Pallas kernel in interpret mode (atol 1e-5: the same exact products
  summed in another order);
- `attention.bwd_layout` gives each registry head size its instance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.ops import quant as jquant
from dualhyp_tpu.ops.pallas import int4_kernel
from dualhyp_tpu_torch.ops import attention, int4

FP32_ATOL = 1e-5

# (N, K) of the int4 linears the middle rows reach: TinyLlama-1.1B's at a
# verify step (qkv, attn.proj, fc_1, mlp.proj, lm_head), Whisper-large-v3's
# decoder at a beam step (q/k/v/out, fc1, fc2), phi-2's qkv; the card
# tests' edge shapes
MID_SHAPES = [(2560, 2048), (2048, 2048), (5632, 2048), (2048, 5632), (32000, 2048),
              (1280, 1280), (5120, 1280), (1280, 5120), (7680, 2560), (100, 640), (320, 128)]
MID_ROWS = [17, 36, 72, 144, 256, 400, 512]


def _stored(plan, rows, n, k):
    """(outputs stored, group products taken) by the plan's CTAs as
    q4_mid_kernel enumerates them: counts over (token, column) and over
    (token tile, column, group)."""
    groups = k // int4.KERNEL_GROUP
    stored = np.zeros((rows, plan["col_blocks"] * int4.MID_COLS), np.int32)
    taken = np.zeros((plan["tiles"], plan["col_blocks"], groups), np.int32)
    for block in range(plan["ctas"]):
        rank, unit = block % plan["cluster"], block // plan["cluster"]
        cb, tile = unit % plan["col_blocks"], unit // plan["col_blocks"]
        m0 = tile * plan["tokens"]
        tokens = min(plan["tokens"], rows - m0)
        assert tokens > 0
        g0, g1 = plan["groups"][rank]
        assert g1 > g0  # every rank takes a group
        taken[tile, cb, g0:g1] += 1
        c0, c1 = plan["columns"][rank]
        stored[m0:m0 + tokens, cb * int4.MID_COLS + c0:cb * int4.MID_COLS + c1] += 1
    return stored[:, :n], taken


@pytest.mark.parametrize("rows", MID_ROWS)
@pytest.mark.parametrize("n,k", MID_SHAPES)
def test_q4_mid_plan_takes_every_output_and_group_once(rows, n, k):
    plan = int4.mid_plan(rows, n, k)
    assert plan["tokens"] in int4.MID_TILES and plan["threads"] == 256
    assert plan["tiles"] * plan["tokens"] >= rows > (plan["tiles"] - 1) * plan["tokens"]
    if rows <= int4.MID_TILES[-1]:
        assert plan["tiles"] == 1  # every token on N: the weight read once
    assert plan["cluster"] in int4.MID_CLUSTERS and plan["cluster"] <= int4.MAX_CLUSTER
    assert plan["ctas"] == plan["col_blocks"] * plan["tiles"] * plan["cluster"]
    assert plan["col_blocks"] * int4.MID_COLS >= n > (plan["col_blocks"] - 1) * int4.MID_COLS
    assert plan["smem"] <= int4.SMEM_LIMIT
    stored, taken = _stored(plan, rows, n, k)
    assert (stored == 1).all() and (taken == 1).all()


def test_q4_mid_plan_at_the_main_paths_shapes():
    # the verify step's 144 rows and the beam's 400 (three tiles of 144):
    # one wave of CTAs, K split on chip where the column blocks are few
    # (fc1 at 400 rows fills the card with its 40 blocks alone)
    got = {(rows, n, k): (int4.path_of(rows, n, k), int4.mid_plan(rows, n, k)["cluster"])
           for rows, n, k in [(144, 2560, 2048), (144, 5632, 2048), (400, 1280, 1280),
                              (400, 1280, 5120), (400, 5120, 1280)]}
    assert got == {(144, 2560, 2048): ("mid", 4), (144, 5632, 2048): ("mid", 2),
                   (400, 1280, 1280): ("mid", 4), (400, 1280, 5120): ("mid", 4),
                   (400, 5120, 1280): ("mid", 1)}
    for rows, n, k in got:
        plan = int4.mid_plan(rows, n, k)
        assert plan["ctas"] <= int4.mid_fill(plan["cluster"])
        assert plan["tiles"] == (3 if rows == 400 else 1)


def test_q4_dispatch_crosses_paths_at_its_row_limits():
    n, k = 1280, 1280
    assert int4.MID_ROWS == 512  # past the Whisper beam's 8 x 50 rows
    assert [int4.path_of(r, n, k) for r in (1, 16, 17, int4.MID_ROWS, int4.MID_ROWS + 1)] == [
        "decode", "decode", "mid", "mid", "wgmma"]
    # TinyLlama's lm_head: two waves of CTAs at 144 rows, four at 256
    assert [int4.path_of(r, 32000, 2048) for r in (144, 256)] == ["mid", "wgmma"]
    for rows in (16, int4.MID_ROWS + 1):
        with pytest.raises(ValueError):
            int4.mid_plan(rows, n, k)
    with pytest.raises(ValueError):
        int4.mid_plan(144, n, 1000)  # K not a multiple of the group


def q4_mid_emulation(x, packed, scales):
    """q4_mid_kernel in fp32, in its order: per token tile and cluster rank,
    each group's 8 k16 steps (16 products each, k in order) summed, the sum
    scaled by the group's scale, the rank's groups in turn; the ranks'
    parts added in rank order."""
    x = x.float()
    rows, k = x.shape
    n = packed.shape[0]
    plan = int4.mid_plan(rows, n, k)
    b = packed.to(torch.int64) & 0xFF
    w = torch.stack([(b << 60) >> 60, (b << 56) >> 60], -1).reshape(n, k).float()
    out = torch.zeros((rows, n))
    for tile in range(plan["tiles"]):
        xt = x[tile * plan["tokens"]:(tile + 1) * plan["tokens"]]
        total = None
        for g0, g1 in plan["groups"]:
            acc = torch.zeros((xt.shape[0], n))
            for g in range(g0, g1):
                part = torch.zeros_like(acc)
                for step in range(8):
                    ks = slice(128 * g + 16 * step, 128 * g + 16 * step + 16)
                    part += xt[:, ks] @ w[:, ks].t()
                acc += part * scales[:, g]
            total = acc if total is None else total + acc
        out[tile * plan["tokens"]:tile * plan["tokens"] + xt.shape[0]] = total
    return out


@pytest.mark.parametrize("rows", [36, 144, 400])
def test_q4_mid_order_matches_plain_and_pallas(rng, rows):
    w = rng.normal(size=(320, 640)).astype(np.float32) * 0.05
    x = rng.normal(size=(rows, 640)).astype(np.float32)
    packed, scale = jquant.quantize_weight_int4(jnp.asarray(w))
    tp, ts = torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(scale))
    plan = int4.mid_plan(rows, 320, 640)
    assert plan["cluster"] > 1  # five groups over the ranks
    got = q4_mid_emulation(torch.from_numpy(x), tp, ts)
    want = np.asarray(int4_kernel.q4_matmul(jnp.asarray(x), packed, scale))
    plain = int4.q4_matmul_plain(torch.from_numpy(x), tp, ts)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=FP32_ATOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_ATOL)


# K1's backward: each registry head size's instance (the row width read,
# 100 in place by cp.async), warpgroups of 64 keys, the narrow box past 64
# columns at 80 and 96, and the column split at 256
BWD_LAYOUTS = {32: (32, 2, 0, 1), 64: (64, 2, 0, 1), 80: (80, 2, 16, 1), 96: (96, 2, 32, 1),
               100: (100, 1, 0, 1), 128: (128, 1, 0, 1), 256: (256, 1, 0, 2)}


@pytest.mark.parametrize("d", attention.FLASH_HEAD_SIZES)
def test_k1_backward_layout_of_each_head_size(d):
    lay = attention.bwd_layout(d)
    assert (lay["instance"], lay["warpgroups"], lay["tail"], lay["parts"]) == BWD_LAYOUTS[d]
    assert lay["keys"] == 64 * lay["warpgroups"]
    # every column in a whole 64-column box or the narrow one, none past D
    assert lay["boxes"] * 64 + lay["tail"] == lay["instance"] or (
        not lay["tail"] and lay["boxes"] * 64 >= lay["instance"] > (lay["boxes"] - 1) * 64)
    # the narrow boxes' instances have no producer warpgroup (eight warps:
    # 255 registers a thread) and add the warpgroups' dQ before one reduce
    assert lay["producer_warpgroup"] == (not lay["tail"]) and lay["merged_dq"] == bool(lay["tail"])
    with pytest.raises(ValueError):
        attention.bwd_layout(48)
