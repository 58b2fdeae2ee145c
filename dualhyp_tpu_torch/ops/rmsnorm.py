"""RMS and layer normalization.

Counterpart of `dualhyp_tpu/ops/rmsnorm.py`. Semantics match the reference
(ref: ger/rmsnorm.py:4-24): y = scale * x / sqrt(mean(x^2) + eps), eps
inside the sqrt, no mean subtraction, no unit offset; the statistic is taken
in fp32 whatever the activation dtype.

`rms_norm` launches kernel K2 (`csrc/rmsnorm.cu`) on a CUDA tensor and runs
the plain version on a CPU tensor. With grad enabled it goes through
`RMSNorm`, whose backward is the analytic formula of the JAX package's
custom VJP (`rmsnorm_kernel._bwd`, jnp there, plain PyTorch here).
"""

from __future__ import annotations

import torch

from dualhyp_tpu_torch.ops import _lib

# K2: replaces dualhyp_tpu/ops/pallas/rmsnorm_kernel.py `_kernel`. Bound by
# bytes (one read, one write per element); one warp a row reads it once as
# 16-byte vectors, keeps it in registers and reduces by shuffles. See the
# source note in csrc/rmsnorm.cu.
RMS_NORM = _lib.Kernel(
    "dh_rms_norm",
    [_lib.C_PTR, _lib.C_PTR, _lib.C_PTR, _lib.C_I64, _lib.C_INT, _lib.C_F32,
     _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_INT],
)
MAX_HELD = 16  # 16-byte vectors a lane of K2 may keep in registers (kMaxHeld)
ROWS_PER_BLOCK = 4  # rows a block of K2, one warp each (kMaxRowsPerBlock)
SPLIT_WARPS = 8  # warps a row below FEW_ROWS rows (kSplitWarps)
# below this many rows K2 takes one row a block, split over SPLIT_WARPS warps
# where the row has that many warps' vectors: the rows spread over as many
# SMs as there are rows, a row's loads over 8 warps
FEW_ROWS = 512


def row_plan(rows: int, d: int, itemsize: int, *ptrs: int) -> tuple[int, int, int, int]:
    """K2's instance for `rows` rows of width d: (width, held, rows_per_block,
    split).

    width: elements a lane loads at once, a 16-byte vector (8 bf16, 4 fp32)
    where d is a multiple of it and every pointer (x, scale, out) is 16-byte
    aligned, else 1. held: the vectors a lane keeps in registers so the row
    is read once (the least power of two that holds the row), or 0 where
    the row is wider than MAX_HELD a lane or is read one element a load: the
    kernel then reads it twice. Below FEW_ROWS rows a block takes one row,
    split over SPLIT_WARPS warps (split) where the row has at least one
    vector a lane of them and at most 4, else over one warp; from FEW_ROWS
    rows on, ROWS_PER_BLOCK rows of one warp each."""
    few = rows < FEW_ROWS
    per_block = 1 if few else ROWS_PER_BLOCK
    width = 16 // itemsize
    if d % width or any(p % 16 for p in ptrs):
        return 1, 0, per_block, 1
    vectors = d // width
    lanes = 32 * SPLIT_WARPS
    if few and lanes <= vectors <= 4 * lanes:
        return width, next(h for h in (1, 2, 4) if lanes * h >= vectors), 1, SPLIT_WARPS
    held = next((h for h in (1, 2, 4, 8, MAX_HELD) if 32 * h >= vectors), 0)
    return width, held, per_block, 1


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """The plain PyTorch version of K2 (`_rms_norm_xla` of the JAX package)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = x32 * torch.reciprocal(torch.sqrt(ms + eps))
    return (scale.to(acc) * normed).to(x.dtype)


def rms_norm_bwd(x, scale, g, eps: float = 1e-5, need_scale: bool = True):
    """Gradients of `rms_norm` (`rmsnorm_kernel._bwd`), in fp32:
    dx = r*gs - x*r^3*sum(gs*x)/D with r = rsqrt(mean(x^2) + eps) and
    gs = g*scale; dscale = sum over rows of g*x*r (None unless asked)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32, g32, s32 = x.to(acc), g.to(acc), scale.to(acc)
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    gs = g32 * s32
    dot = (gs * x32).sum(dim=-1, keepdim=True)
    dx = r * gs - x32 * r ** 3 * dot / x.shape[-1]
    dscale = None
    if need_scale:
        dscale = (g32 * x32 * r).reshape(-1, x.shape[-1]).sum(0).to(scale.dtype)
    return dx.to(x.dtype), dscale


class RMSNorm(torch.autograd.Function):
    """K2 forward; the analytic backward in plain PyTorch."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, g, ctx.eps, ctx.needs_input_grad[1])
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """RMSNorm over the last axis. x: (..., d) bf16 or fp32; scale: (d,)."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    return _rms_norm(x, scale, eps)


def _rms_norm(x, scale, eps):
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    device = _lib.check_cuda(x, scale)
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} for width {d}")
    x2 = x.reshape(-1, d).contiguous()
    scale32 = scale.to(torch.float32).contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows >= 2**31:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    if rows:
        ptrs = (x2.data_ptr(), scale32.data_ptr(), out.data_ptr())
        RMS_NORM(device, *ptrs, rows, d, float(eps), _lib.dtype_code(x2),
                 *row_plan(rows, d, x2.element_size(), *ptrs))
    return out.reshape(x.shape)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    """Standard LayerNorm with the statistics in fp32 (plain PyTorch)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * scale.float() + bias.float()).to(x.dtype)
