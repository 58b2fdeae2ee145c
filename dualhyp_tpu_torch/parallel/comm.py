"""The collectives that GSPMD inserts in the JAX package, written out.

Each op takes a process group from `Mesh.group` (None: an extent of 1, and
the op is the identity). Those that sit on a gradient path are
`torch.autograd.Function`s whose backward is their transpose:

  * `copy_to` (Megatron's f): identity forward, all-reduce backward; on the
    input of a column-parallel region, and on a replicated leaf that a
    rank uses in part (its gradient is a sum over the ranks);
  * `reduce_from` (Megatron's g): all-reduce forward, identity backward;
    on the output of a row-parallel region;
  * `all_gather`, whose backward reduce-scatters: FSDP's gather of a
    leaf, the sequence-parallel gather of q, k and v;
  * `gather_from`: all-gather forward, this rank's slice backward (the
    vocab-parallel head's logits, whose loss every tensor rank computes);
  * `ppermute`: the shift of a pipeline's activations to the next stage;
    its backward shifts the other way.

Backends. NCCL takes every op on the card. Gloo takes every op used here
(all_reduce, broadcast, the single-tensor all-gather and reduce-scatter,
all_to_all_single, the object collectives) on CPU tensors, and on CUDA
tensors too: two ranks sharing one H100 (NCCL refuses a duplicate GPU)
checked each of them for the right values under torch 2.11 (PERF.md). Torch
documents gloo's send / recv as CPU-only, so nothing here uses them: the
pipeline's `ppermute` is an all_to_all_single whose splits are zero but
for the destination's, which every backend takes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the single-tensor gather and reduce-scatter under their current names
_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# ---- plain collectives (no autograd) ----

def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place, over `group`; returns x."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    _gather_single(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter of {x.shape[dim]} over {n} ranks")
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    _scatter_single(out, src, group=group)
    return out.movedim(0, dim)


def local_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous 1/n of x along dim."""
    n = size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} does not split over {n} ranks")
    step = x.shape[dim] // n
    return x.narrow(dim, rank(group) * step, step)


def _shift(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    """Rank i's x goes to rank (i + shift) mod n: one all_to_all_single
    whose splits are zero but for the destination's."""
    n, me = size(group), rank(group)
    dst, src_rank = (me + shift) % n, (me - shift) % n
    flat = x.contiguous().reshape(-1)
    numel = flat.numel()
    out = flat.new_empty(numel)
    send = [numel if r == dst else 0 for r in range(n)]
    recv = [numel if r == src_rank else 0 for r in range(n)]
    dist.all_to_all_single(out, flat, recv, send, group=group)
    return out.reshape(x.shape)


def broadcast_objects(objects: list, src: int = 0, group=None) -> list:
    """`broadcast_object_list` from global rank `src` (the world's group
    when None); returns the list as rank src holds it."""
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.broadcast_object_list(objects, src=src, group=group)
    return objects


def all_gather_objects(obj, group=None) -> list:
    """Every rank's `obj`, in rank order."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# ---- autograd ops ----

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.group), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return local_slice(grad, ctx.dim, ctx.group).contiguous(), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _shift(x, shift, group)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, -ctx.shift, ctx.group), None, None


def copy_to(x, group):
    """Megatron's f: identity forward, all-reduce of the gradient."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Megatron's g: all-reduce forward, identity backward."""
    return x if group is None else _ReduceFrom.apply(x, group)


def all_gather(x, dim: int, group):
    """The ranks' x concatenated along dim in group order; the gradient is
    reduce-scattered back (summed over the ranks, this rank's slice)."""
    return x if group is None else _AllGather.apply(x, dim, group)


def gather_from(x, dim: int, group):
    """All-gather along dim whose backward keeps this rank's slice: for a
    result every rank of the group goes on to use alike."""
    return x if group is None else _GatherFrom.apply(x, dim, group)


def ppermute(x, group, shift: int = 1):
    """x of group rank i goes to rank (i + shift) mod n (`lax.ppermute`
    with the cyclic permutation); the gradient goes back the other way."""
    return x if group is None else _Shift.apply(x, shift, group)
