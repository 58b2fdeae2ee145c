"""Rotary position embeddings.

Counterpart of `dualhyp_tpu/ops/rope.py`; numerics match the reference
(ref: ger/model.py:319-355): theta_i = base^(-2i/n_elem), positions divided
by condense_ratio, the angle table tiled twice along the channels, and
rotate-half application roped = x*cos + cat(-x2, x1)*sin on the leading
n_elem channels (partial rotary: the rest pass through).

`apply_rope` launches kernel K3 (`csrc/rope.cu`) on a CUDA tensor and runs
the plain version on a CPU tensor. `apply_rope_gathered` is the decode
step's per-row position path, which the JAX package also keeps outside its
kernel.
"""

from __future__ import annotations

import torch

from dualhyp_tpu_torch.ops import _lib

# K3: replaces dualhyp_tpu/ops/pallas/rope_kernel.py `_kernel`. Bound by
# bytes (x read once, out written once); it reads strided head views and
# writes contiguous heads. See the source note in csrc/rope.cu.
ROPE = _lib.Kernel(
    "dh_rope",
    [_lib.C_PTR, _lib.C_PTR, _lib.C_PTR, _lib.C_PTR, _lib.C_I64, _lib.C_INT,
     _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_I64, _lib.C_I64,
     _lib.C_I64, _lib.C_I64, _lib.C_INT, _lib.C_INT],
)


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
    x32 = x.float()
    head = x32[..., :n_elem]
    x1, x2 = head[..., :half], head[..., half:]
    rotated = torch.cat([x2, -x1] if transpose else [-x2, x1], dim=-1)
    roped = head * cos.float() + rotated * sin.float()
    return torch.cat([roped, x32[..., n_elem:]], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               transpose: bool = False):
    """Rotary embedding on the leading n_elem = cos.shape[-1] channels.

    x: (..., T, head_size); on CUDA any strides with a unit channel stride
    (up to five dimensions are read in place); cos, sin: (T, n_elem) in x's
    dtype. Returns a new contiguous tensor."""
    n_elem = cos.shape[-1]
    if n_elem == 0:
        return x
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
        ROPE(device, x5.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
             n0, n1, n2, t, d, n_elem, *x5.stride()[:4], int(transpose),
             _lib.dtype_code(x5))
    return out.reshape(x.shape)


def apply_rope_gathered(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                        positions: torch.Tensor):
    """Decode-step rotary embedding at per-row positions (plain PyTorch).

    x: (B, H, 1, head_size); cos, sin: (S, n_elem) tables; positions: (B,).
    Mirrors the gather path of `dualhyp_tpu/models/gpt.py:_block`, which
    applies the jnp formula in x's dtype."""
    n_elem = cos.shape[-1]
    if n_elem == 0:
        return x
    cos_b = cos[positions][:, None, None, :]  # (B, 1, 1, n_elem)
    sin_b = sin[positions][:, None, None, :]
    half = n_elem // 2
    head = x[..., :n_elem]
    rotated = torch.cat([-head[..., half:], head[..., :half]], dim=-1)
    roped = (head * cos_b + rotated * sin_b).to(x.dtype)
    return torch.cat([roped, x[..., n_elem:]], dim=-1)
