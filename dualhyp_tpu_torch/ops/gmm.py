"""Grouped matrix product over expert row groups: kernel L2.

Counterpart of the grouped GEMM `gdot` of `dualhyp_tpu/models/gpt.py`
`_moe_mlp_sparse`: megablox `gmm` under DUALHYP_MOE_IMPL=megablox and
`jax.lax.ragged_dot` under =sparse, which compute the same function.
`grouped_matmul` launches L2 (`csrc/grouped_matmul.cu`) on a CUDA tensor
and runs `grouped_matmul_plain` on a CPU tensor. Forward only: the MoE path
serves; its backward (megablox `tgmm`) waits for MoE training.

Layout: lhs (M, K) with its rows sorted by group; weight (E, N, K), the
port's stored (out, in) layout of an expert stack, which is megablox's
`transpose_rhs=True` form (the JAX package transposes its stacks to (E, K,
N) instead; here no stack is ever transposed or copied); group_sizes (E,)
int32: rows [off[e], off[e] + group_sizes[e]) use weight[e], with off the
exclusive cumulative sum. Rows past the last group are zero, as ragged_dot
leaves them.
"""

from __future__ import annotations

import torch

from dualhyp_tpu_torch.ops import _lib

# L2: replaces megablox `gmm` (jax/experimental/pallas/ops/tpu/megablox/
# gmm.py). Bound by the expert weight bytes in decode (16 rows) and by
# operations in prefill (thousands of rows); each block finds its (group,
# row tile) from the group sizes on the device, so no size is read back to
# the host. See csrc/grouped_matmul.cu.
GROUPED_MATMUL = _lib.Kernel(
    "dh_grouped_matmul",
    [_lib.C_PTR] * 4 + [_lib.C_INT] * 4,
)


def grouped_matmul_plain(lhs, weight, group_sizes):
    """The plain PyTorch version of L2: a loop over the groups of products
    in fp32 (fp64 for fp64 inputs), rounded once to lhs's dtype. It reads
    the group sizes on the host."""
    acc_t = torch.promote_types(lhs.dtype, torch.float32)
    m = lhs.shape[0]
    out = torch.zeros((m, weight.shape[1]), dtype=acc_t, device=lhs.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(m, start + max(int(size), 0))
        if end > start:
            out[start:end] = lhs[start:end].to(acc_t) @ weight[e].to(acc_t).t()
        start = end
    return out.to(lhs.dtype)


def _aligned(t) -> bool:
    return t.is_contiguous() and not t.data_ptr() % 16


def grouped_matmul(lhs, weight, group_sizes):
    """lhs (M, K) @ weight[e(m)] (E, N, K) transposed, by row group: (M, N)
    in lhs's dtype, summed in fp32.

    On the card lhs and weight are bfloat16, group_sizes int32, K a multiple
    of 8 and weight contiguous (it is never copied); M, N, empty groups and
    groups that are not aligned to the kernel's tiles are arbitrary."""
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, weight, group_sizes)
    device = _lib.check_cuda(lhs, weight, group_sizes)
    if torch.is_grad_enabled() and (lhs.requires_grad or weight.requires_grad):
        raise NotImplementedError(
            "grouped_matmul's backward (megablox tgmm) is not ported yet")
    if lhs.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(f"grouped matmul kernel takes bfloat16 lhs and weight, "
                        f"got {lhs.dtype}, {weight.dtype}")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"grouped matmul kernel takes int32 group sizes, got "
                        f"{group_sizes.dtype}")
    if (lhs.dim() != 2 or weight.dim() != 3 or weight.shape[2] != lhs.shape[1]
            or group_sizes.shape != (weight.shape[0],)):
        raise ValueError(f"lhs {tuple(lhs.shape)}, weight {tuple(weight.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")
    m, k = lhs.shape
    e, n, _ = weight.shape
    if k % 8:
        raise ValueError(f"grouped matmul kernel takes K % 8 == 0 (16-byte rows), got "
                         f"lhs {tuple(lhs.shape)}, weight {tuple(weight.shape)}")
    if not _aligned(weight):
        raise ValueError(f"grouped matmul kernel takes a contiguous, 16-byte aligned "
                         f"weight (E, N, K), got strides {weight.stride()}")
    if not _aligned(lhs):  # a fresh contiguous copy is 16-byte aligned
        lhs = lhs.clone(memory_format=torch.contiguous_format)
    group_sizes = group_sizes.contiguous()
    out = torch.empty((m, n), dtype=lhs.dtype, device=device)
    if m and n:
        GROUPED_MATMUL(device, lhs.data_ptr(), weight.data_ptr(), group_sizes.data_ptr(),
                       out.data_ptr(), m, n, k, e)
    return out
