"""L2's forward at decode rows (at most 32) on the CPU: its launch plan, and
its order of sums against the plain version and megablox `gmm`.

On the card `csrc/grouped_matmul.cu` (`gmm_decode_kernel`) streams each busy
expert's weight rows through a cp.async ring into mma.sync products in one
launch a call, its CTAs in clusters that split K and add the parts in shared
memory
(`test_torch_kernels.py` and `chip_smoke.py` hold it to the plain version
there). Here:

- `gmm.decode_plan` takes every K step once and stores every output
  element once: the kernel's schedule, replayed for every CTA of the plan
  from its index arithmetic, writes each (row, column) of the output exactly
  once, at rows 1 to 32 with ragged, empty, single groups and rows past the
  last group, with clusters of at most 8 CTAs; it pins the cluster at the
  Mixtral decode shapes and refuses more than DECODE_ROWS rows;
- a numpy emulation of the kernel's order of sums (each rank's fp32 part
  over its 128-deep chunks of K, each chunk's mma.sync products of 16 k in
  order, the parts added in rank order, rounded once) agrees with
  `grouped_matmul_plain` and with megablox `gmm` in Pallas interpret mode in
  fp32 at `test_torch_moe.py`'s tolerance (1e-5: the same exact products
  summed in another order), at the cases of that file's group sizes (its
  40 rows brought to the kernel's 32), and with `jax.lax.ragged_dot` where
  rows lie past the last group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import megablox

from dualhyp_tpu_torch.ops import gmm
from tests.test_torch_moe import GMM_ATOL, GROUP_SIZES

# test_torch_moe.py's GROUP_SIZES cases (ragged, an empty first, middle or
# last group, one group) at 32 rows, the decode kernel's most
DECODE_GROUP_SIZES = {
    "ragged": [4, 13, 3, 12],
    "empty_first": [0, 16, 9, 7],
    "empty_middle": [8, 0, 0, 24],
    "empty_last": [10, 6, 16, 0],
    "one_group": [0, 32, 0, 0],
}

N_EXPERT = 8
# group sizes of m rows over 8 experts: ragged, empty groups, one group, and
# rows past the last group
CASES = {
    "ragged": lambda m: [m // 8] * 7 + [m - 7 * (m // 8)],
    "empty": lambda m: [0, m // 3, 0, 0, m // 5, m - m // 3 - m // 5 - m // 7, m // 7, 0],
    "single": lambda m: [0, 0, 0, m, 0, 0, 0, 0],
    "past_last": lambda m: [m // 3, 0, m // 4, 0, 0, 0, 0, 0],
}
# (N, K): Mixtral's fc_1 and proj, the card tests' long K, small ragged ones
SHAPES = [(14336, 4096), (4096, 14336), (256, 14336), (200, 264), (24, 40)]


def kernel_writes(plan, sizes, m, n):
    """How many times gmm_decode_kernel's CTAs write each output element,
    from its index arithmetic: CTA b of a cluster of `ranks` is rank b %
    ranks of unit b / ranks, visit unit / col_blocks (group e, or the rows
    past the last group at e = n_groups), column block unit % col_blocks;
    it stores its rank's columns of the block for the visit's rows."""
    counts = np.zeros((m, n), np.int64)
    ranks, col_blocks = plan["cluster"], plan["col_blocks"]
    for block in range(plan["ctas"]):
        unit, rank = divmod(block, ranks)
        e, cb = divmod(unit, col_blocks)
        start = 0
        for i in range(e):
            start = min(m, start + max(sizes[i], 0))
        end = min(m, start + max(sizes[e], 0)) if e < len(sizes) else m
        if end <= start:
            continue
        lo, hi = plan["columns"][rank]
        c0 = cb * gmm.DECODE_COLS
        counts[start:end, c0 + lo:min(n, c0 + hi)] += 1
    return counts


@pytest.mark.parametrize("rows", [1, 8, 9, 16, 17, 24, 32])
@pytest.mark.parametrize("n,k", SHAPES)
@pytest.mark.parametrize("case", list(CASES))
def test_decode_plan_stores_every_element_once_and_takes_every_step(rows, n, k, case):
    plan = gmm.decode_plan(rows, n, k, N_EXPERT)
    cluster = plan["cluster"]
    assert 1 <= cluster <= gmm.MAX_CLUSTER and cluster & (cluster - 1) == 0
    assert plan["ctas"] == plan["visits"] * plan["col_blocks"] * cluster
    assert plan["visits"] == N_EXPERT + 1 and plan["threads"] == 128
    assert plan["token_tiles"] * 8 >= rows and plan["smem"] <= 227 * 1024
    # the K split lives in the cluster: one share of the chunks a rank, at
    # least MIN_CHUNKS where there is a split
    chunks = -(-k // gmm.DECODE_K)
    taken = [s for lo, hi in plan["chunks"] for s in range(lo, hi)]
    assert taken == list(range(chunks)) and all(hi > lo for lo, hi in plan["chunks"])
    assert cluster == 1 or min(hi - lo for lo, hi in plan["chunks"]) >= gmm.MIN_CHUNKS
    widths = [hi - lo for lo, hi in plan["columns"]]
    assert plan["columns"][0][0] == 0 and plan["columns"][-1][1] == gmm.DECODE_COLS
    assert len(set(widths)) == 1 and len(widths) == cluster
    sizes = CASES[case](rows)
    assert min(sizes) >= 0 and sum(sizes) <= rows
    np.testing.assert_array_equal(kernel_writes(plan, sizes, rows, n), 1)


def test_decode_plan_pins_the_cluster_at_the_mixtral_decode_shapes():
    # 16 rows (8 tokens x top 2) over 8 experts: fc_1 (and fc_2) N 14336 K
    # 4096, proj N 4096 K 14336
    assert gmm.decode_plan(16, 14336, 4096, 8)["cluster"] == 2
    assert gmm.decode_plan(16, 4096, 14336, 8)["cluster"] == 4
    assert gmm.DECODE_ROWS == 32
    assert gmm.decode_plan(32, 256, 14336, 8)["cluster"] == 4
    with pytest.raises(ValueError):
        gmm.decode_plan(33, 4096, 14336, 8)
    with pytest.raises(ValueError):
        gmm.decode_plan(16, 4096, 14340, 8)  # K % 8


def decode_emulation(lhs, w, sizes):
    """gmm_decode_kernel's arithmetic in numpy fp32: for each group's rows,
    each cluster rank's part over its share of K's 128-deep chunks (K
    padded with zeros to whole chunks, as the ring's copies zero-fill past
    K), each chunk's mma.sync products of 16 k in order added into the
    part; the ranks' parts added in rank order. Rows past the last group
    stay zero."""
    m, k = lhs.shape
    n = w.shape[1]
    plan = gmm.decode_plan(m, n, k, w.shape[0])
    chunks = -(-k // gmm.DECODE_K)
    pad = chunks * gmm.DECODE_K - k
    lp = np.pad(lhs, ((0, 0), (0, pad)))
    wp = np.pad(w, ((0, 0), (0, 0), (0, pad)))
    out = np.zeros((m, n), np.float32)
    start = 0
    for e, size in enumerate(sizes):
        end = min(m, start + max(int(size), 0))
        if end > start:
            total = None
            for c0, c1 in plan["chunks"]:
                part = np.zeros((end - start, n), np.float32)
                for k0 in range(c0 * gmm.DECODE_K, c1 * gmm.DECODE_K, 16):
                    part += lp[start:end, k0:k0 + 16] @ wp[e][:, k0:k0 + 16].T
                total = part if total is None else total + part
            out[start:end] = total
        start = end
    return out


def _inputs(rng, m, n=24, k=4104):
    # outputs of order 1: fp32 sums of their size in another order stay
    # within GMM_ATOL
    lhs = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(N_EXPERT // 2, n, k)).astype(np.float32) * 0.02  # (E, N, K)
    return lhs, w


@pytest.mark.parametrize("case", GROUP_SIZES)
def test_decode_order_matches_plain_and_megablox(rng, case):
    sizes = np.asarray(DECODE_GROUP_SIZES[case], np.int32)
    m = int(sizes.sum())
    lhs, w = _inputs(rng, m)
    k, n = lhs.shape[1], w.shape[1]
    # 33 chunks of K (the last holds 8 k) over a cluster of 2: uneven shares
    assert gmm.decode_plan(m, n, k, len(sizes))["cluster"] == 2
    got = decode_emulation(lhs, w, sizes)
    plain = gmm.grouped_matmul_plain(torch.from_numpy(lhs), torch.from_numpy(w),
                                     torch.from_numpy(sizes)).numpy()
    want = megablox.gmm(jnp.asarray(lhs), jnp.asarray(w), jnp.asarray(sizes),
                        preferred_element_type=jnp.float32, tiling=(8, k, n),
                        transpose_rhs=True, interpret=True)
    np.testing.assert_allclose(got, plain, rtol=0, atol=GMM_ATOL)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=GMM_ATOL)


@pytest.mark.parametrize("rows,sizes", [(1, [0, 0, 0, 0]), (10, [3, 0, 4, 0]),
                                        (32, [0, 11, 5, 13])])
def test_decode_order_zeroes_rows_past_the_last_group(rng, rows, sizes):
    lhs, w = _inputs(rng, rows)
    got = decode_emulation(lhs, w, sizes)
    assert not got[sum(sizes):].any()
    want = jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(w.transpose(0, 2, 1)),
                              jnp.asarray(sizes, jnp.int32),
                              precision=jax.lax.Precision.HIGHEST)
    plain = gmm.grouped_matmul_plain(torch.from_numpy(lhs), torch.from_numpy(w),
                                     torch.tensor(sizes, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=GMM_ATOL)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=GMM_ATOL)
