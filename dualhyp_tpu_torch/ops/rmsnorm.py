"""RMS and layer normalization.

Counterpart of `dualhyp_tpu/ops/rmsnorm.py`. Semantics match the reference
(ref: ger/rmsnorm.py:4-24): y = scale * x / sqrt(mean(x^2) + eps), eps
inside the sqrt, no mean subtraction, no unit offset; the statistic is taken
in fp32 whatever the activation dtype.

`rms_norm` launches kernel K2 (`csrc/rmsnorm.cu`) on a CUDA tensor and runs
the plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from dualhyp_tpu_torch.ops import _lib

# K2: replaces dualhyp_tpu/ops/pallas/rmsnorm_kernel.py `_kernel`. Bound by
# bytes (one read, one write per element); one block per row keeps the fp32
# statistic on chip. See the source note in csrc/rmsnorm.cu.
RMS_NORM = _lib.Kernel(
    "dh_rms_norm",
    [_lib.C_PTR, _lib.C_PTR, _lib.C_PTR, _lib.C_I64, _lib.C_INT, _lib.C_F32,
     _lib.C_INT],
)


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """The plain PyTorch version of K2 (`_rms_norm_xla` of the JAX package)."""
    x32 = x.float()
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = x32 * torch.reciprocal(torch.sqrt(ms + eps))
    return (scale.float() * normed).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """RMSNorm over the last axis. x: (..., d) bf16 or fp32; scale: (d,)."""
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
        RMS_NORM(device, x2.data_ptr(), scale32.data_ptr(), out.data_ptr(), rows, d,
                 float(eps), _lib.dtype_code(x2))
    return out.reshape(x.shape)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    """Standard LayerNorm with the statistics in fp32 (plain PyTorch)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * scale.float() + bias.float()).to(x.dtype)
