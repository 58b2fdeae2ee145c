"""The launch plan of the middle-row kernel of K4 and K5.

`csrc/mid_matmul.cuh` `mid_kernel` computes a product at a verify step's
rows (K5 above `lora.DECODE_ROWS`, K4 above `swiglu.DECODE_ROWS`, up to each
one's MID_ROWS): every token of a tile on wgmma's N, 128 weight rows (output
columns) a CTA on its M (64 for K4's gate, whose CTA takes them of W1 and of
W2), the contraction's 64-deep steps split over
a cluster of CTAs whose fp32 parts meet in the owners' shared memory. This
module mirrors the kernel's shared-memory layout so that a plan is checked
here, on the CPU, before a launch (`plan`), and the tests can enumerate
what each CTA takes and stores.
"""

from __future__ import annotations

import functools

# the token tiles (wgmma's N) of the kernel's instances (`DH_MID_CASE` in
# the source); a warpgroup's sums take N / 2 fp32 registers a thread
MID_TILES = (48, 72, 96, 144)
STEP = 64  # contraction depth of a step of the ring
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232448  # shared memory a CTA may take on an H100 (227 KB)
# the clusters a plan takes: eight CTAs a cluster ran slower than four at
# every shape timed (the exchange of the parts; NVIDIA H100 80GB HBM3,
# PERF.md), as K8's middle kernel did
CLUSTERS = (1, 2, 4)


def fill(cluster: int) -> int:
    """CTAs of the kernel (one an SM) the card holds at once in clusters of
    `cluster`: all 132 in pairs, 128 in clusters of 4 or 8 (a cluster lies
    in one GPC of 16 or 18 SMs)."""
    return SMS if cluster <= 2 else 128


def shape(tokens: int, wg: int, parts: int = 1, rank: bool = False, sep: bool = False) -> dict:
    """`mid::Shape` of the source: warpgroups (`parts` x `wg` over weight
    rows, one more over A's rows with `rank`), threads (theirs and a
    producer warpgroup's), columns a CTA, the
    bytes of a ring step (x's box, xin's with `sep`, a 64-row box a
    warpgroup), the steps in flight (as many as 200 KB hold, 2 to 6) and
    the fp32 parts' row stride in floats."""
    groups = parts * wg + (1 if rank else 0)
    producers = 4  # warps streaming the ring
    stage = (2 if rank and sep else 1) * tokens * 128 + groups * 64 * 128
    stages = min(max(200 * 1024 // stage, 2), 6)
    return dict(groups=groups, threads=128 * groups + 32 * producers, cols=64 * wg,
                stage=stage, stages=stages,
                ring=stages * stage, ld=tokens + (24 - tokens % 16) % 16, tokens=tokens)


def smem(sh: dict, parts: int, rank: bool, cluster: int, r: int) -> int:
    """Shared memory bytes a CTA (`mid::Shape::smem`): the ring, which after
    the loop the fp32 parts (the CTA's columns' parts of every rank, and A's
    parts of every rank) and h = bf16(xin A^T) overwrite; B's rows of the
    owned columns (16 a tile, the rank padded to 16, rows 8 elements
    longer), the mbarriers (A's parts; each ring step's full and empty),
    1 KB to align the base."""
    parts_bytes = (parts * sh["cols"] + (cluster * r if rank else 0)) * sh["ld"] * 4
    r16 = -(-r // 16) * 16
    h_bytes = sh["tokens"] * (r16 + 8) * 2 if rank else 0
    b_bytes = -(-(sh["cols"] // cluster) // 16) * 16 * (r16 + 8) * 2 if rank else 0
    return max(sh["ring"], parts_bytes + h_bytes) + b_bytes + 16 + 16 * sh["stages"] + 1024


@functools.lru_cache(maxsize=None)
def plan(rows: int, n: int, k: int, *, parts: int = 1, rank: bool = False, sep: bool = False,
         r: int = 0, cluster: int | None = None) -> dict:
    """The launch of the middle kernel for (rows, k) x (n, k)^T: `tiles`
    token tiles of `tokens` (the fewest tiles of at most 144, each the
    narrowest MID_TILES width that holds its share), column blocks of `wg`
    x 64 (2, the gate 1), each block's ceil(k / 64) steps split over a
    `cluster` of CTAs
    (rank c takes `steps[c]`, one at least, and adds up and stores
    `columns[c]` of the block): the largest of CLUSTERS whose CTAs the card
    holds at once and whose shared memory fits (or `cluster` as given).
    `parts` 2: the gate (W1 and W2 over the same rows); `rank`: K5's A tile
    (r rows, a multiple of 8), over a separate xin with `sep`."""
    if rows < 1 or n < 1 or k < 1 or (rank and not 0 < r <= 64):
        raise ValueError(f"middle rows {rows}, N {n}, K {k}, rank {r}")
    wg = 1 if parts == 2 else 2
    tiles = -(-rows // MID_TILES[-1])
    tokens = next(w for w in MID_TILES if w * tiles >= rows)
    sh = shape(tokens, wg, parts, rank, sep)
    blocks = -(-n // sh["cols"])
    steps = -(-k // STEP)

    def fits(c):
        return c <= min(steps, 8) and smem(sh, parts, rank, c, r) <= SMEM_LIMIT

    if cluster is None:  # (a cluster given, up to 8, is taken as it is)
        fitting = [c for c in CLUSTERS if fits(c)]
        if not fitting:
            raise ValueError(f"no cluster fits N {n}, K {k} at {rows} rows")
        one_wave = [c for c in fitting if blocks * tiles * c <= fill(c)]
        cluster = max(one_wave) if one_wave else min(fitting)
    elif not fits(cluster):
        raise ValueError(f"cluster {cluster} does not fit N {n}, K {k} at {rows} rows")
    cols = sh["cols"] // cluster
    return dict(tiles=tiles, tokens=tokens, wg=wg, col_blocks=blocks, cluster=cluster,
                ctas=blocks * tiles * cluster, threads=sh["threads"], stages=sh["stages"],
                smem=smem(sh, parts, rank, cluster, r),
                steps=[(c * steps // cluster, (c + 1) * steps // cluster)
                       for c in range(cluster)],
                columns=[(c * cols, (c + 1) * cols) for c in range(cluster)])
