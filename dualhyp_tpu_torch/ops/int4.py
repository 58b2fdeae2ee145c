"""Group-wise int4 weights times activations: kernel K8.

Counterpart of `dualhyp_tpu/ops/pallas/int4_kernel.py` `q4_matmul`.
`q4_matmul` launches K8 (`csrc/int4_matmul.cu`) on a CUDA tensor and runs
`q4_matmul_plain` on a CPU tensor. Forward only: the quantized path serves,
it does not train.

Layout (`ops/quant.quantize_weight_int4`): packed int8 (N, K / 2) holds
columns (2c, 2c + 1) of row n in byte c, the low nibble the even column;
scales fp32 (N, K / group), one per group of `group` input columns.
"""

from __future__ import annotations

import functools

import torch

from dualhyp_tpu_torch.ops import _lib

# K8: replaces dualhyp_tpu/ops/pallas/int4_kernel.py `_kernel`. Bound by the
# packed weight bytes in decode (8 rows) and by operations in prefill
# (thousands of rows); the packed bytes unpack in registers, into the
# tensor-core operands, and no dequantised value is stored. Prefill rows run
# a wgmma/TMA kernel with the weights on wgmma's M side; middle rows (a
# verify step's, a Whisper beam step's) a wgmma kernel with every token of a
# tile on N, the weight streamed once a tile by cp.async and K split over a
# cluster whose parts meet in shared memory (`mid_plan`); decode rows one
# kernel that streams the packed bytes into mma.sync fragments with 16-byte
# loads, its CTAs in clusters that split K and add the parts in shared
# memory (`decode_plan`). See csrc/int4_matmul.cu.
Q4_MATMUL = _lib.Kernel(
    "dh_q4_matmul",
    [_lib.C_PTR, _lib.C_I64, _lib.C_PTR, _lib.C_PTR, _lib.C_PTR, _lib.C_PTR,
     _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_INT],
)

KERNEL_GROUP = 128  # the only group size the kernel takes
# rows at or below which the kernel takes its decode path
DECODE_ROWS = 16
DECODE_COLS = 128  # output columns a CTA of the decode kernel: 8 warps of 16
# rows at or below which (above DECODE_ROWS) it takes its middle path: the
# middle kernel beat the wgmma tile at 17 to 512 rows of every shape timed
# but where its CTAs took more than two waves (lm_head at 256 and 512 rows;
# `path_of`, PERF.md); larger rows were not timed on it
MID_ROWS = 512
MID_COLS = 128  # output columns a CTA of the middle kernel: two warpgroups of 64
# the middle kernel's token tiles (wgmma's N, `DH_MID_TILES` in the source):
# a warpgroup holds a tile's group sum and its running sum, N fp32 registers
# a thread, so 200 is the widest
MID_TILES = (24, 48, 72, 96, 120, 144, 168, 200)
MID_STAGES = 3  # groups in the middle kernel's cp.async ring
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8  # CTAs of a cluster, the portable most
# clusters the middle kernel takes: eight of its 185 KB CTAs ran slower than
# four on every shape timed (NVIDIA H100 80GB HBM3, PERF.md)
MID_CLUSTERS = (1, 2, 4)
SMEM_LIMIT = 232448  # shared memory a CTA may take on an H100 (227 KB)
PATHS = ("decode", "mid", "wgmma")  # the kernel's `path` argument
# launches of each path (Q4_MATMUL.launches counts them all): a run reads
# them to show which path its calls took
PATH_LAUNCHES = dict.fromkeys(PATHS, 0)


def tile(rows: int) -> tuple:
    """(tokens, output columns, CTAs that fill the card) of K8's CTA at
    `rows`: the decode kernel's (four CTAs an SM, all resident at once,
    each with its loads in flight), the wgmma kernel's (one CTA an SM)."""
    if rows <= DECODE_ROWS:
        return DECODE_ROWS, DECODE_COLS, 4 * 132
    return 128, 128, 132


@functools.lru_cache(maxsize=None)
def decode_cluster(rows: int, n: int, k: int) -> tuple:
    """(cluster, CTAs, shared memory bytes a CTA) of K8's decode kernel at
    `rows` <= DECODE_ROWS (`decode_plan`); raises where K's slice of x
    would not fit a CTA's shared memory."""
    if not 0 < rows <= DECODE_ROWS or k % KERNEL_GROUP or n < 1:
        raise ValueError(f"decode rows {rows}, N {n}, K {k}")
    groups = k // KERNEL_GROUP
    blocks = -(-n // DECODE_COLS)
    fill = tile(rows)[2]
    cluster = 1
    while cluster < MAX_CLUSTER and 2 * blocks * cluster <= fill and 2 * cluster <= groups:
        cluster *= 2
    per = -(-groups // cluster)
    smem = 8 * -(-rows // 8) * ((per * KERNEL_GROUP + 32) * 2 + DECODE_COLS * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K {k} takes {smem} bytes of shared memory a CTA at {rows} rows")
    return cluster, blocks * cluster, smem


def decode_plan(rows: int, n: int, k: int) -> dict:
    """The launch of K8's decode kernel at `rows` <= DECODE_ROWS: CTAs of
    DECODE_COLS output columns, `cluster` of them a column block, each
    taking an even share of the K / 128 groups (`groups[rank]`); the
    cluster's CTAs add their fp32 parts in shared memory in rank order, CTA
    `rank` for `columns[rank]` of the block, so nothing goes through device
    memory. The cluster is the largest power of two, at most MAX_CLUSTER
    and the group count, whose CTAs the card holds at once (`tile`): each
    CTA's share of K then takes the least time. `smem`: its bytes a CTA
    (the x slice, staged once, and the cluster's parts of its columns)."""
    cluster, ctas, smem = decode_cluster(rows, n, k)
    groups = k // KERNEL_GROUP
    cols = DECODE_COLS // cluster
    return dict(token_tiles=-(-rows // 8), col_blocks=ctas // cluster, cluster=cluster,
                ctas=ctas, threads=256, smem=smem,
                groups=[(c * groups // cluster, (c + 1) * groups // cluster)
                        for c in range(cluster)],
                columns=[(c * cols, (c + 1) * cols) for c in range(cluster)])


def mid_fill(cluster: int) -> int:
    """CTAs of the middle kernel (one an SM) the card holds at once in
    clusters of `cluster`: all 132 in pairs, 128 in clusters of 4 (a
    cluster lies in one GPC of 16 or 18 SMs)."""
    return SMS if cluster <= 2 else 128


@functools.lru_cache(maxsize=None)
def mid_plan(rows: int, n: int, k: int) -> dict:
    """The launch of K8's middle kernel at DECODE_ROWS < `rows` <= MID_ROWS:
    `tiles` token tiles of `tokens` tokens (a MID_TILES width) by column
    blocks of MID_COLS, each block's K / 128 groups split over a `cluster`
    of CTAs (rank r takes `groups[r]`; at least one each) whose fp32 parts
    meet in shared memory, CTA r adding `columns[r]` of the block in rank
    order: one launch, no workspace. Each tile streams the weight once: up
    to 200 rows one tile holds every token; above, of the fewest tiles and
    one more, and clusters of MID_CLUSTERS, the plan takes the least
    modelled time, waves x (groups a rank x (tokens + 32) + 512): a group
    costs its tokens and 32 more (a k16 step's unpacking and issue, in token
    columns), a wave 512 (its first loads and its cluster's sums, about
    three groups of 144 tokens); ties go to fewer tiles, then the smaller
    cluster."""
    if not DECODE_ROWS < rows <= MID_ROWS or k % KERNEL_GROUP or n < 1:
        raise ValueError(f"middle rows {rows}, N {n}, K {k}")
    groups = k // KERNEL_GROUP
    blocks = -(-n // MID_COLS)
    least = -(-rows // MID_TILES[-1])
    best = None
    for tiles in range(least, least + (1 if least == 1 else 2)):
        tokens = next(w for w in MID_TILES if w * tiles >= rows)
        for cluster in MID_CLUSTERS:
            if cluster > groups:
                break
            ctas = blocks * tiles * cluster
            waves = -(-ctas // mid_fill(cluster))
            cost = waves * (-(-groups // cluster) * (tokens + 32) + 512)
            if best is None or cost < best[0]:
                best = (cost, tiles, tokens, cluster, ctas)
    _, tiles, tokens, cluster, ctas = best
    cols = MID_COLS // cluster
    # a stage: x's group (tokens x 256 bytes), the packed rows (80 bytes
    # each) and their scales; the ring turns into the parts (the CTA's and
    # those it receives: 128 rows each of tokens padded to 8 words past a
    # multiple of 32) at the end; an mbarrier
    ring = MID_STAGES * (256 * tokens + MID_COLS * 80 + 1024)
    parts = 2 * MID_COLS * 4 * (tokens + (40 - tokens % 32) % 32)
    return dict(tiles=tiles, tokens=tokens, col_blocks=blocks, cluster=cluster, ctas=ctas,
                threads=256, smem=max(ring, parts) + 8 + 1024,
                groups=[(c * groups // cluster, (c + 1) * groups // cluster)
                        for c in range(cluster)],
                columns=[(c * cols, (c + 1) * cols) for c in range(cluster)])


def path_of(rows: int, n: int, k: int) -> str:
    """The kernel's path at `rows` x (N, K) (`PATHS`): decode up to
    DECODE_ROWS; mid up to MID_ROWS where its CTAs fit two waves (each tile
    streams the whole weight, so many column blocks of several tiles lose
    to the wgmma tile); wgmma elsewhere."""
    if rows <= DECODE_ROWS:
        return "decode"
    if rows <= MID_ROWS:
        plan = mid_plan(rows, n, k)
        if plan["ctas"] <= 2 * mid_fill(plan["cluster"]):
            return "mid"
    return "wgmma"


def unpack_int4(packed: torch.Tensor):
    """Packed int8 (..., K // 2) -> the sign-extended (low, high) nibbles
    as int32, each (..., K // 2): the even and the odd columns."""
    w = packed.to(torch.int32)
    return (w << 28) >> 28, w >> 4


def q4_matmul_plain(x, packed, scales, group: int = 128):
    """The plain PyTorch version of K8, in the Pallas kernel's arithmetic:
    the nibbles sign-extended to x's dtype (exact for [-7, 7]), x's even and
    odd columns against the low and high planes, each group's product
    summed in fp32 and multiplied by the group's scale after the product,
    one rounding to x's dtype at the end. (`dequantize_weight_int4` and a
    matmul round q * s to x's dtype first; in bf16 the two differ.)"""
    k = x.shape[-1]
    n = packed.shape[0]
    if k % group or k % 2 or packed.shape[1] * 2 != k or scales.shape != (n, k // group):
        raise ValueError(f"x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, group {group}")
    acc_t = torch.promote_types(x.dtype, torch.float32)
    lo, hi = (v.to(x.dtype).to(acc_t) for v in unpack_int4(packed))
    x2 = x.reshape(-1, k)
    xe = x2[:, 0::2].to(acc_t)
    xo = x2[:, 1::2].to(acc_t)
    rep = group // 2  # packed columns per group
    acc = torch.zeros((x2.shape[0], n), dtype=acc_t, device=x.device)
    for g in range(k // group):
        sl = slice(g * rep, (g + 1) * rep)
        partial = xe[:, sl] @ lo[:, sl].t() + xo[:, sl] @ hi[:, sl].t()
        acc += partial * scales[:, g].to(acc_t)
    return acc.to(x.dtype).reshape(*x.shape[:-1], n)


def split_k(rows: int, n: int, groups: int) -> tuple:
    """(splits, groups per split) of K8's wgmma kernel (rows > MID_ROWS):
    the K loop is split across CTAs when the output tiles alone cannot
    fill the card; the splits' fp32 parts then sum in a fixed order in a
    second pass."""
    tile_m, tile_n, min_blocks = tile(rows)
    tiles = -(-rows // tile_m) * -(-n // tile_n)
    if tiles >= min_blocks:
        return 1, groups
    per = -(-groups // min(groups, -(-min_blocks // tiles)))
    return -(-groups // per), per


def q4_matmul(x, packed, scales, group: int = 128):
    """x (..., K) @ dequant4(packed (N, K // 2), scales (N, K // group)).T.

    Returns (..., N) in x's dtype. On the card x is bfloat16, K a multiple
    of 128 and group 128; rows and N are arbitrary."""
    if x.device.type == "cpu":
        return q4_matmul_plain(x, packed, scales, group)
    device = _lib.check_cuda(x, packed, scales)
    k = x.shape[-1]
    n = packed.shape[0]
    if group != KERNEL_GROUP:
        raise ValueError(f"int4 kernel takes group {KERNEL_GROUP}, got {group}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int4 kernel takes bfloat16 activations, got {x.dtype}")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"int4 kernel takes int8 packed weights and fp32 scales, "
                        f"got {packed.dtype}, {scales.dtype}")
    if k % KERNEL_GROUP or packed.shape != (n, k // 2) or scales.shape != (n, k // group):
        raise ValueError(f"x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}: K must be a multiple of "
                         f"{KERNEL_GROUP}")
    x2 = x.reshape(-1, k)
    if x2.stride(-1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    if not packed.is_contiguous() or packed.data_ptr() % 16:  # read in place, 16 bytes a load
        packed = packed.clone(memory_format=torch.contiguous_format)
    scales = scales.contiguous()
    rows = x2.shape[0]
    out = torch.empty((rows, n), dtype=x.dtype, device=device)
    if not rows or not n:
        return out.reshape(*x.shape[:-1], n)
    ws = out
    path = path_of(rows, n, k)
    if path == "decode":  # one launch: the K split meets on chip
        splits, per = decode_cluster(rows, n, k)[0], 0
    elif path == "mid":  # one launch too
        plan = mid_plan(rows, n, k)
        splits, per = plan["cluster"], plan["tokens"]
    else:
        splits, per = split_k(rows, n, k // KERNEL_GROUP)
        if splits > 1:
            ws = torch.empty((splits, rows, n), dtype=torch.float32, device=device)
    Q4_MATMUL(device, x2.data_ptr(), x2.stride(0), packed.data_ptr(), scales.data_ptr(),
              out.data_ptr(), ws.data_ptr(), rows, n, k, PATHS.index(path), splits, per,
              flops=2 * rows * n * k)
    PATH_LAUNCHES[path] += 1
    return out.reshape(*x.shape[:-1], n)
