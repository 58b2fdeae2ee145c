"""SwiGLU MLP and the plain linear.

Counterpart of `dualhyp_tpu/ops/swiglu.py`. Weights keep torch's
(out_features, in_features) layout. `swiglu_mlp` launches kernel K4
(`csrc/swiglu.cu`) on a CUDA tensor and runs the plain version on a CPU
tensor; its weights are in x's dtype, as on the JAX package's XLA path,
which casts them to x's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dualhyp_tpu_torch.ops import _lib

# K4: replaces dualhyp_tpu/ops/pallas/swiglu_kernel.py `_kernel`. Bound by
# operations in prefill and by weight bytes in decode; blocks split the
# intermediate dimension and keep the gate in shared memory, adding partial
# products with fp32 atomics. See the source note in csrc/swiglu.cu.
SWIGLU = _lib.Kernel(
    "dh_swiglu_mlp",
    [_lib.C_PTR, _lib.C_PTR, _lib.C_PTR, _lib.C_PTR, _lib.C_PTR, _lib.C_PTR,
     _lib.C_INT, _lib.C_INT, _lib.C_INT, _lib.C_INT],
)

GATES = ("silu", "gelu")


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def swiglu_mlp_plain(x, w1, w2, w3, gate: str = "silu"):
    """The plain PyTorch version of K4, in the kernel's arithmetic: the two
    gate products accumulate in fp32, h is rounded to x's dtype, and the
    down projection accumulates in fp32 before the final rounding."""
    x32 = x.float()
    a = x32 @ w1.float().t()
    b = x32 @ w2.float().t()
    act = F.silu(a) if gate == "silu" else _gelu_tanh(a)
    h = (act * b).to(x.dtype)
    return (h.float() @ w3.float().t()).to(x.dtype)


def swiglu_mlp(x, w1, w2, w3, gate: str = "silu"):
    """(act(x @ w1.T) * (x @ w2.T)) @ w3.T with act silu or tanh-gelu.

    x: (..., d); w1, w2: (inter, d); w3: (d, inter), all in x's dtype."""
    if gate not in GATES:
        raise ValueError(f"gate {gate!r} not in {GATES}")
    if x.device.type == "cpu":
        return swiglu_mlp_plain(x, w1, w2, w3, gate)
    device = _lib.check_cuda(x, w1, w2, w3)
    d = x.shape[-1]
    inter = w1.shape[0]
    if w1.shape != (inter, d) or w2.shape != (inter, d) or w3.shape != (d, inter):
        raise ValueError(
            f"weights {tuple(w1.shape)}, {tuple(w2.shape)}, {tuple(w3.shape)} "
            f"for width {d}")
    for t in (x, w1, w2, w3):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"swiglu kernel takes bfloat16, got {t.dtype}")
    if d % 64 or inter % 8:
        raise ValueError(f"swiglu kernel needs d % 64 == 0 and inter % 8 == 0, "
                         f"got d={d}, inter={inter}")
    x2 = x.reshape(-1, d).contiguous()
    w1, w2, w3 = w1.contiguous(), w2.contiguous(), w3.contiguous()
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    if rows:
        acc = torch.empty((rows, d), dtype=torch.float32, device=device)
        SWIGLU(device, x2.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
               acc.data_ptr(), out.data_ptr(), rows, d, inter, int(gate == "gelu"))
    return out.reshape(x.shape)


def linear(x, w, b=None):
    """Plain torch-layout linear in x's dtype (the JAX package leaves these
    products to XLA; here they go to torch.matmul)."""
    y = x @ w.to(x.dtype).t()
    if b is not None:
        y = y + b.to(x.dtype)
    return y
