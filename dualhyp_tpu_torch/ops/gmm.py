"""Grouped matrix product over expert row groups, and its gradients: kernel L2.

Counterpart of the grouped GEMM `gdot` of `dualhyp_tpu/models/gpt.py`
`_moe_mlp_sparse`: megablox `gmm` under DUALHYP_MOE_IMPL=megablox and
`jax.lax.ragged_dot` under =sparse, which compute the same function, with
megablox's custom VJP `_gmm_bwd` (`gmm` with the other transpose for the
gradient of lhs, `tgmm` for the weight's). `grouped_matmul` launches L2's
forward (`csrc/grouped_matmul.cu`) on a CUDA tensor and runs
`grouped_matmul_plain` on a CPU tensor; with grad it goes through
`GroupedMatmul`, whose backward launches `grouped_matmul_dlhs` when lhs
needs a gradient and `grouped_matmul_drhs` only when the weight does (the
expert stacks are frozen under LoRA, so LoRA training never runs it).

Layout: lhs (M, K) with its rows sorted by group; weight (E, N, K), the
port's stored (out, in) layout of an expert stack, which is megablox's
`transpose_rhs=True` form (the JAX package transposes its stacks to (E, K,
N) instead; here no stack is ever transposed or copied); group_sizes (E,)
int32: rows [off[e], off[e] + group_sizes[e]) use weight[e], with off the
exclusive cumulative sum. Rows past the last group are zero, as ragged_dot
leaves them, and so are their gradients.
"""

from __future__ import annotations

import functools

import torch

from dualhyp_tpu_torch.ops import _lib

# L2: replaces megablox `gmm` (jax/experimental/pallas/ops/tpu/megablox/
# gmm.py). Bound by the expert weight bytes in decode (16 rows) and by
# operations in prefill and training (thousands of rows); each block finds
# its group's rows from the group sizes on the device, so no size is read
# back to the host. Above DECODE_ROWS a wgmma/TMA kernel (128 x 256 tiles);
# at or below, one launch of a decode kernel that streams each busy
# expert's weight rows through a cp.async ring into mma.sync products (the
# weights on M, a group's rows as N), no tensor map encoded, its CTAs in
# clusters that split K and add the parts in shared memory (`decode_plan`).
# See csrc/grouped_matmul.cu.
GROUPED_MATMUL = _lib.Kernel(
    "dh_grouped_matmul",
    [_lib.C_PTR] * 4 + [_lib.C_INT] * 5,
)
# L2's gradient of lhs: replaces megablox `_gmm_bwd`'s `gmm` with the other
# transpose (ops.py). The forward's TMA kernel and schedule, with the stack
# read along its stored rows (wgmma's MN-major B): bound by operations at the
# training rows. At or below 64 rows an mma.sync tile (cp.async,
# ldmatrix.trans), which no path runs: training takes 16384 rows.
GROUPED_MATMUL_DLHS = _lib.Kernel(
    "dh_grouped_matmul_dlhs",
    [_lib.C_PTR] * 4 + [_lib.C_INT] * 4,
)
# L2's gradient of the weight: replaces megablox `tgmm` (gmm.py). A wgmma/TMA
# kernel at every row count: one block per (expert, 128 N, 256 K) tile walks
# its group's rows, found on the device, 64 a step (g^T and lhs both read
# MN-major, the next group's rows zeroed in the last step) and writes its
# tile of the (E, N, K) stack once. Bound by operations.
GROUPED_MATMUL_DRHS = _lib.Kernel(
    "dh_grouped_matmul_drhs",
    [_lib.C_PTR] * 4 + [_lib.C_INT] * 4,
)


# rows at or below which the forward runs its decode kernel (kDecodeRows)
DECODE_ROWS = 32
DECODE_COLS = 64  # output columns a CTA of the decode kernel: 4 warps of 16 weight rows
DECODE_K = 128  # k a stage of the decode kernel's ring: 256 bytes of each row
MAX_CLUSTER = 8  # CTAs of a cluster, the portable most
MIN_CHUNKS = 16  # stages of K a rank of a cluster streams, at least


@functools.lru_cache(maxsize=None)
def decode_cluster(rows: int, n: int, k: int, n_groups: int) -> int:
    """The cluster of L2's decode kernel at `rows` <= DECODE_ROWS
    (`decode_plan`)."""
    if not 0 < rows <= DECODE_ROWS or n < 1 or k < 8 or k % 8 or n_groups < 1:
        raise ValueError(f"decode rows {rows}, N {n}, K {k}, groups {n_groups}")
    chunks = -(-k // DECODE_K)
    cluster = 1
    while cluster < MAX_CLUSTER and chunks // (2 * cluster) >= MIN_CHUNKS:
        cluster *= 2
    return cluster


def decode_plan(rows: int, n: int, k: int, n_groups: int) -> dict:
    """The launch of L2's decode kernel at `rows` <= DECODE_ROWS, fixed by
    rows, N, K and the group count alone (the group sizes stay on the
    device): one visit a group and one for the rows past the last group
    (`visits`; an empty one exits at once), each by `col_blocks` blocks of
    DECODE_COLS output columns, `cluster` CTAs a block, each taking an even
    share of K's DECODE_K-deep chunks (`chunks[rank]`); the cluster's CTAs
    add their fp32 parts in shared memory in rank order, CTA `rank` for
    `columns[rank]` of the block, so nothing goes through device memory. A
    visit's rows are N in `token_tiles` n8 tiles. The cluster is the largest
    power of two, at most MAX_CLUSTER, that leaves every rank MIN_CHUNKS
    chunks at least: shorter streams and more CTAs, whose last wave on the
    card is shorter (at Mixtral's decode shapes 2 and 4 beat 1 and 8 on
    the card, PERF.md). `smem`: its bytes a CTA (a three-stage ring of the
    weight rows and the visit's rows, and the cluster's parts of its
    columns)."""
    cluster = decode_cluster(rows, n, k, n_groups)
    col_blocks = -(-n // DECODE_COLS)
    chunks = -(-k // DECODE_K)
    tiles = next(t for t in (1, 2, 4) if 8 * t >= rows)
    cols = DECODE_COLS // cluster
    return dict(token_tiles=tiles, visits=n_groups + 1, col_blocks=col_blocks, cluster=cluster,
                ctas=(n_groups + 1) * col_blocks * cluster, threads=128,
                smem=3 * (DECODE_COLS + 8 * tiles) * (DECODE_K + 8) * 2
                + 8 * tiles * DECODE_COLS * 4,
                chunks=[(c * chunks // cluster, (c + 1) * chunks // cluster)
                        for c in range(cluster)],
                columns=[(c * cols, (c + 1) * cols) for c in range(cluster)])


def _groups(group_sizes, m: int):
    """(e, start, end) of each non-empty group, clamped to m rows, read on
    the host (the plain versions' loop)."""
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(m, start + max(int(size), 0))
        if end > start:
            yield e, start, end
        start = end


def grouped_matmul_plain(lhs, weight, group_sizes):
    """The plain PyTorch version of L2: a loop over the groups of products
    in fp32 (fp64 for fp64 inputs), rounded once to lhs's dtype. It reads
    the group sizes on the host."""
    acc_t = torch.promote_types(lhs.dtype, torch.float32)
    out = torch.zeros((lhs.shape[0], weight.shape[1]), dtype=acc_t, device=lhs.device)
    for e, start, end in _groups(group_sizes, lhs.shape[0]):
        out[start:end] = lhs[start:end].to(acc_t) @ weight[e].to(acc_t).t()
    return out.to(lhs.dtype)


def grouped_matmul_dlhs_plain(grad, weight, group_sizes):
    """The plain version of L2's lhs gradient: grad (M, N) times weight[e]
    (N, K) by row group, in fp32 (fp64 for fp64), rounded once to grad's
    dtype; rows past the last group are zero."""
    acc_t = torch.promote_types(grad.dtype, torch.float32)
    out = torch.zeros((grad.shape[0], weight.shape[2]), dtype=acc_t, device=grad.device)
    for e, start, end in _groups(group_sizes, grad.shape[0]):
        out[start:end] = grad[start:end].to(acc_t) @ weight[e].to(acc_t)
    return out.to(grad.dtype)


def grouped_matmul_drhs_plain(grad, lhs, group_sizes):
    """The plain version of L2's weight gradient: dW[e] (N, K) = grad^T lhs
    over group e's rows, in fp32 (fp64 for fp64), rounded once to lhs's
    dtype; an empty group's is zero. Returns (E, N, K)."""
    acc_t = torch.promote_types(lhs.dtype, torch.float32)
    out = torch.zeros((group_sizes.shape[0], grad.shape[1], lhs.shape[1]), dtype=acc_t,
                      device=lhs.device)
    for e, start, end in _groups(group_sizes, lhs.shape[0]):
        out[e] = grad[start:end].to(acc_t).t() @ lhs[start:end].to(acc_t)
    return out.to(lhs.dtype)


def _aligned(t) -> bool:
    return t.is_contiguous() and not t.data_ptr() % 16


def _rows(t):
    """t itself when its rows can be read in place, else a fresh contiguous
    (so 16-byte aligned) copy."""
    return t if _aligned(t) else t.clone(memory_format=torch.contiguous_format)


def _check(name: str, group_sizes, *mats) -> torch.device:
    """The kernels' common refusals: CUDA bfloat16 matrices, int32 sizes."""
    device = _lib.check_cuda(*mats, group_sizes)
    for t in mats:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bfloat16 matrices, got {t.dtype}")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"{name} kernel takes int32 group sizes, got {group_sizes.dtype}")
    return device


def _check_weight(name: str, weight, what: str) -> None:
    if not _aligned(weight):
        raise ValueError(f"{name} kernel takes a contiguous, 16-byte aligned {what}, got "
                         f"strides {weight.stride()}")


def _grouped_matmul(lhs, weight, group_sizes):
    """L2's forward alone: the kernel on the card, the plain version on the
    CPU."""
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, weight, group_sizes)
    device = _check("grouped matmul", group_sizes, lhs, weight)
    if (lhs.dim() != 2 or weight.dim() != 3 or weight.shape[2] != lhs.shape[1]
            or group_sizes.shape != (weight.shape[0],)):
        raise ValueError(f"lhs {tuple(lhs.shape)}, weight {tuple(weight.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")
    m, k = lhs.shape
    e, n, _ = weight.shape
    if k % 8:
        raise ValueError(f"grouped matmul kernel takes K % 8 == 0 (16-byte rows), got "
                         f"lhs {tuple(lhs.shape)}, weight {tuple(weight.shape)}")
    _check_weight("grouped matmul", weight, "weight (E, N, K)")
    lhs = _rows(lhs)
    group_sizes = group_sizes.contiguous()
    out = torch.empty((m, n), dtype=lhs.dtype, device=device)
    if m and n:
        cluster = decode_cluster(m, n, k, e) if m <= DECODE_ROWS else 1
        GROUPED_MATMUL(device, lhs.data_ptr(), weight.data_ptr(), group_sizes.data_ptr(),
                       out.data_ptr(), m, n, k, e, cluster, flops=2 * m * n * k)
    return out


def _check_backward(name, grad, other, group_sizes, n, k):
    """The backward kernels read grad's and the stack's or lhs's rows by
    16-byte copies: N and K multiples of 8."""
    if grad.dim() != 2 or grad.shape[1] != n or group_sizes.dim() != 1:
        raise ValueError(f"grad {tuple(grad.shape)}, {name} {tuple(other.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")
    if n % 8 or k % 8:
        raise ValueError(f"grouped matmul backward kernels take N % 8 == 0 and K % 8 == 0 "
                         f"(16-byte rows), got N {n}, K {k}")


def grouped_matmul_dlhs(grad, weight, group_sizes):
    """The gradient of `grouped_matmul` with respect to lhs: grad (M, N)
    times weight[e(m)] (N, K), (M, K) in grad's dtype, summed in fp32.

    On the card grad and weight are bfloat16, group_sizes int32, N and K
    multiples of 8, weight contiguous (read in place, never transposed)."""
    if grad.device.type == "cpu":
        return grouped_matmul_dlhs_plain(grad, weight, group_sizes)
    device = _check("grouped matmul dlhs", group_sizes, grad, weight)
    if weight.dim() != 3 or group_sizes.shape != (weight.shape[0],):
        raise ValueError(f"weight {tuple(weight.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)}")
    e, n, k = weight.shape
    _check_backward("weight", grad, weight, group_sizes, n, k)
    _check_weight("grouped matmul dlhs", weight, "weight (E, N, K)")
    grad = _rows(grad)
    group_sizes = group_sizes.contiguous()
    m = grad.shape[0]
    out = torch.empty((m, k), dtype=grad.dtype, device=device)
    if m:
        GROUPED_MATMUL_DLHS(device, grad.data_ptr(), weight.data_ptr(), group_sizes.data_ptr(),
                            out.data_ptr(), m, n, k, e, flops=2 * m * n * k)
    return out


def grouped_matmul_drhs(grad, lhs, group_sizes):
    """The gradient of `grouped_matmul` with respect to the weight: dW[e] =
    grad^T lhs over group e's rows, (E, N, K) in lhs's dtype (the stack's
    stored layout), summed in fp32; an empty group's is zero.

    On the card grad (M, N) and lhs (M, K) are bfloat16, group_sizes (E,)
    int32, N and K multiples of 8."""
    if lhs.device.type == "cpu":
        return grouped_matmul_drhs_plain(grad, lhs, group_sizes)
    device = _check("grouped matmul drhs", group_sizes, grad, lhs)
    if lhs.dim() != 2 or lhs.shape[0] != grad.shape[0]:
        raise ValueError(f"grad {tuple(grad.shape)}, lhs {tuple(lhs.shape)}")
    m, k = lhs.shape
    n = grad.shape[1]
    _check_backward("lhs", grad, lhs, group_sizes, n, k)
    grad, lhs = _rows(grad), _rows(lhs)
    group_sizes = group_sizes.contiguous()
    e = group_sizes.shape[0]
    out = torch.empty((e, n, k), dtype=lhs.dtype, device=device)
    if out.numel():
        GROUPED_MATMUL_DRHS(device, grad.data_ptr(), lhs.data_ptr(), group_sizes.data_ptr(),
                            out.data_ptr(), m, n, k, e, flops=2 * m * n * k)
    return out


class GroupedMatmul(torch.autograd.Function):
    """`grouped_matmul` with megablox's VJP (`_gmm_bwd`): the lhs gradient
    by `grouped_matmul_dlhs`, the weight's by `grouped_matmul_drhs`, each
    only where its input needs one. lhs is kept for the backward only when
    the weight takes a gradient, the weight only when lhs does."""

    @staticmethod
    def forward(ctx, lhs, weight, group_sizes):
        need_lhs, need_weight = ctx.needs_input_grad[:2]
        ctx.save_for_backward(lhs if need_weight else None, weight if need_lhs else None,
                              group_sizes)
        ctx.weight_dtype = weight.dtype
        return _grouped_matmul(lhs, weight, group_sizes)

    @staticmethod
    def backward(ctx, grad):
        lhs, weight, group_sizes = ctx.saved_tensors
        dlhs = dweight = None
        if ctx.needs_input_grad[0]:
            dlhs = grouped_matmul_dlhs(grad, weight, group_sizes)
        if ctx.needs_input_grad[1]:
            dweight = grouped_matmul_drhs(grad, lhs, group_sizes).to(ctx.weight_dtype)
        return dlhs, dweight, None


def grouped_matmul(lhs, weight, group_sizes):
    """lhs (M, K) @ weight[e(m)] (E, N, K) transposed, by row group: (M, N)
    in lhs's dtype, summed in fp32. With grad enabled and an input that
    needs it, the autograd op `GroupedMatmul`.

    On the card lhs and weight are bfloat16, group_sizes int32, K a multiple
    of 8 (N too under grad) and weight contiguous (it is never copied); M,
    N, empty groups and groups that are not aligned to the kernel's tiles
    are arbitrary."""
    if torch.is_grad_enabled() and (lhs.requires_grad or weight.requires_grad):
        return GroupedMatmul.apply(lhs, weight, group_sizes)
    return _grouped_matmul(lhs, weight, group_sizes)
