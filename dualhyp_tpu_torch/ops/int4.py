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
# a wgmma/TMA kernel with the weights on wgmma's M side; decode rows one
# kernel that streams the packed bytes into mma.sync fragments with 16-byte
# loads, its CTAs in clusters that split K and add the parts in shared
# memory (`decode_plan`). See csrc/int4_matmul.cu.
Q4_MATMUL = _lib.Kernel(
    "dh_q4_matmul",
    [_lib.C_PTR, _lib.C_I64, _lib.C_PTR, _lib.C_PTR, _lib.C_PTR, _lib.C_PTR,
     _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_INT],
)

KERNEL_GROUP = 128  # the only group size the kernel takes
# rows at or below which the kernel takes its decode path
DECODE_ROWS = 16
DECODE_COLS = 128  # output columns a CTA of the decode kernel: 8 warps of 16
MAX_CLUSTER = 8  # CTAs of a cluster, the portable most
SMEM_LIMIT = 232448  # shared memory a CTA may take on an H100 (227 KB)


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
    """(splits, groups per split) of K8's wgmma kernel (rows > DECODE_ROWS):
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
    if rows <= DECODE_ROWS:  # one launch: the K split meets on chip
        splits, per = decode_cluster(rows, n, k)[0], 0
    else:
        splits, per = split_k(rows, n, k // KERNEL_GROUP)
        if splits > 1:
            ws = torch.empty((splits, rows, n), dtype=torch.float32, device=device)
    Q4_MATMUL(device, x2.data_ptr(), x2.stride(0), packed.data_ptr(), scales.data_ptr(),
              out.data_ptr(), ws.data_ptr(), rows, n, k, splits, per, flops=2 * rows * n * k)
    return out.reshape(*x.shape[:-1], n)
