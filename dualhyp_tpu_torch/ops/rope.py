"""Rotary position embeddings.

Counterpart of `dualhyp_tpu/ops/rope.py`; numerics match the reference
(ref: ger/model.py:319-355): theta_i = base^(-2i/n_elem), positions divided
by condense_ratio, the angle table tiled twice along the channels, and
rotate-half application roped = x*cos + cat(-x2, x1)*sin on the leading
n_elem channels (partial rotary: the rest pass through).

`apply_rope` launches kernel K3 (`csrc/rope.cu`) on a CUDA tensor and runs
the plain version on a CPU tensor. With grad enabled it goes through `RoPE`,
whose backward is K3 with `transpose=True` (the inverse rotation), as in
the JAX package's custom VJP. `apply_rope_gathered` (the decode step) and
`apply_rope_rows` on `gather_rope_rows` (the verify step) are the per-row
position paths, which the JAX package also keeps outside its kernel.
"""

from __future__ import annotations

import torch

from dualhyp_tpu_torch.ops import _lib

# K3: replaces dualhyp_tpu/ops/pallas/rope_kernel.py `_kernel`. Bound by
# bytes (x read once, out written once); it reads strided head views and
# writes contiguous heads, a thread 16-byte vectors of both halves. See the
# source note in csrc/rope.cu.
ROPE = _lib.Kernel(
    "dh_rope",
    [_lib.C_PTR, _lib.C_PTR, _lib.C_PTR, _lib.C_PTR, _lib.C_I64, _lib.C_INT,
     _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_I64, _lib.C_I64,
     _lib.C_I64, _lib.C_I64, _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_INT,
     _lib.C_INT, _lib.C_INT],
)
# the same kernel launched with transpose=True (the backward), counted apart
# so a run shows both directions
ROPE_T = _lib.Kernel("dh_rope", ROPE.argtypes)
BLOCK_THREADS = 256  # threads a block of K3 at most (csrc/rope.cu kMaxThreads)
MAX_HEADS_PER_BLOCK = 16
# the grid K3 aims at: this many blocks an SM (about one wave of blocks of
# 256 threads), fewer heads a block where that is short; of 2, 3, 6 and 12,
# 3 took the least device time at the training and prefill shapes (within
# 1% at TinyLlama's k; scripts/torch_row_pass_variants.py, PERF.md)
BLOCKS_PER_SM = 3


def launch_plan(heads: int, t: int, d: int, n_elem: int, itemsize: int, strides, ptrs,
                sms: int) -> tuple[int, int, int, int]:
    """K3's instance and block for `heads` (head, T, D) planes:
    (width, row_threads, t_block, heads_per_block).

    width: channels an access, a 16-byte vector (8 bf16, 4 fp32) where each
    half of n_elem, D and every stride (elements) are multiples of it and
    every pointer (x, cos, sin, out) is 16-byte aligned, else 1. A thread
    takes `width` channels of the first half with their partners (or
    `width` pass-through channels): row_threads threads a (head, t) row, up
    to BLOCK_THREADS; t_block positions a block. heads_per_block: the heads
    a thread walks at its position, as many as keep the grid at about
    BLOCKS_PER_SM blocks an SM, between 1 and MAX_HEADS_PER_BLOCK."""
    width = 16 // itemsize
    if n_elem % (2 * width) or d % width or any(s % width for s in strides) or \
            any(p % 16 for p in ptrs):
        width = 1
    row_threads = min((n_elem // 2 + d - n_elem) // width, BLOCK_THREADS)
    t_block = max(1, min(t, BLOCK_THREADS // row_threads))
    tiles = -(-t // t_block)
    heads_per_block = max(1, min(MAX_HEADS_PER_BLOCK, heads * tiles // (BLOCKS_PER_SM * sms)))
    return width, row_threads, t_block, heads_per_block


def build_rope_cache(seq_len: int, n_elem: int, base: int = 10000,
                     condense_ratio: int = 1, dtype=torch.bfloat16,
                     device=None):
    """(cos, sin), each (seq_len, n_elem): built in fp32, then cast to `dtype`."""
    if n_elem == 0:
        empty = torch.zeros((seq_len, 0), dtype=dtype, device=device)
        return empty, empty.clone()
    exponent = torch.arange(0, n_elem, 2, dtype=torch.float32, device=device) / n_elem
    theta = 1.0 / (base ** exponent)
    position = torch.arange(seq_len, dtype=torch.float32, device=device) / condense_ratio
    angles = position[:, None] * theta[None, :]
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     transpose: bool = False):
    """The plain PyTorch version of K3: fp32 math, one rounding at the end.

    transpose=True applies the inverse rotation (the backward)."""
    n_elem = cos.shape[-1]
    half = n_elem // 2
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    head = x32[..., :n_elem]
    x1, x2 = head[..., :half], head[..., half:]
    rotated = torch.cat([x2, -x1] if transpose else [-x2, x1], dim=-1)
    roped = head * cos.to(acc) + rotated * sin.to(acc)
    return torch.cat([roped, x32[..., n_elem:]], dim=-1).to(x.dtype)


class RoPE(torch.autograd.Function):
    """K3 forward; the backward is K3 transposed (`rope_kernel._bwd`)."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _rope(x, cos, sin, False)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return _rope(g, cos, sin, True), None, None


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               transpose: bool = False):
    """Rotary embedding on the leading n_elem = cos.shape[-1] channels.

    x: (..., T, head_size); on CUDA any strides with a unit channel stride
    (up to five dimensions are read in place); cos, sin: (T, n_elem) in x's
    dtype. Returns a new contiguous tensor. With grad enabled and an x that
    needs it, the autograd op `RoPE`, whose gradient reaches x through its
    strides (the fused QKV projection's output)."""
    if cos.shape[-1] == 0:
        return x
    if not transpose and torch.is_grad_enabled() and x.requires_grad:
        return RoPE.apply(x, cos, sin)
    return _rope(x, cos, sin, transpose)


def _rope(x, cos, sin, transpose):
    n_elem = cos.shape[-1]
    if x.device.type == "cpu":
        return apply_rope_plain(x, cos, sin, transpose)
    device = _lib.check_cuda(x, cos, sin)
    t, d = x.shape[-2], x.shape[-1]
    if cos.shape != (t, n_elem) or sin.shape != (t, n_elem):
        raise ValueError(f"cos/sin {tuple(cos.shape)} for x {tuple(x.shape)}")
    if n_elem > d or n_elem % 2:
        raise ValueError(f"n_elem {n_elem} for head size {d}")
    if cos.dtype != x.dtype or sin.dtype != x.dtype:
        raise TypeError(f"cos/sin {cos.dtype} for x {x.dtype}")
    if x.dim() <= 5:
        x5 = x.reshape((1,) * (5 - x.dim()) + tuple(x.shape))
    else:
        x5 = x.reshape(-1, x.shape[-4], x.shape[-3], t, d)
    if x5.stride(-1) != 1:
        x5 = x5.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    out = torch.empty(x5.shape, dtype=x.dtype, device=device)
    if out.numel():
        n0, n1, n2 = x5.shape[:3]
        # a dimension of size 1 is never stepped: its stride does not count
        strides = [s if n > 1 else 0 for n, s in zip(x5.shape[:4], x5.stride()[:4])]
        ptrs = (x5.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr())
        plan = launch_plan(n0 * n1 * n2, t, d, n_elem, x5.element_size(), strides, ptrs,
                           torch.cuda.get_device_properties(device).multi_processor_count)
        if n0 * n1 * n2 >= 2**31 or -(-t // plan[2]) > 65535:
            raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's grid")
        kernel = ROPE_T if transpose else ROPE
        kernel(device, *ptrs, n0, n1, n2, t, d, n_elem, *strides, int(transpose),
               _lib.dtype_code(x5), *plan)
    return out.reshape(x.shape)


def apply_rope_gathered(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                        positions: torch.Tensor):
    """Decode-step rotary embedding at per-row positions (plain PyTorch).

    x: (B, H, 1, head_size); cos, sin: (S, n_elem) tables; positions: (B,).
    Mirrors the gather path of `dualhyp_tpu/models/gpt.py:_block`, which
    applies the jnp formula in x's dtype."""
    if cos.shape[-1] == 0:
        return x
    return apply_rope_rows(x, cos[positions][:, None, None, :],
                           sin[positions][:, None, None, :])


def gather_rope_rows(cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor):
    """The table rows at positions (B, T): (cos, sin), each (B, 1, T,
    n_elem), for `apply_rope_rows`. A position past the table's end gives
    NaN rows, as `jnp.take` fills them in the JAX package's verify step (a
    speculative chunk's drafts may run past block_size; no emitted token
    reads them). The index is clamped first: no read past the end."""
    outside = (positions >= cos.shape[0])[:, None, :, None]
    idx = positions.clamp(max=cos.shape[0] - 1)
    return (cos[idx][:, None].masked_fill(outside, float("nan")),
            sin[idx][:, None].masked_fill(outside, float("nan")))


def apply_rope_rows(x: torch.Tensor, cos_b: torch.Tensor, sin_b: torch.Tensor):
    """Rotary embedding with a row of the table per (batch, position): x
    (B, H, T, head_size), cos_b and sin_b broadcasting against (B, H, T,
    n_elem); the jnp formula in x's dtype (plain PyTorch: the decode and
    verify steps' per-row positions, which the JAX package keeps outside its
    kernel too)."""
    n_elem = cos_b.shape[-1]
    if n_elem == 0:
        return x
    half = n_elem // 2
    head = x[..., :n_elem]
    rotated = torch.cat([-head[..., half:], head[..., :half]], dim=-1)
    roped = (head * cos_b + rotated * sin_b).to(x.dtype)
    return torch.cat([roped, x[..., n_elem:]], dim=-1)
