"""SwiGLU MLP and the plain linear.

Counterpart of `dualhyp_tpu/ops/swiglu.py`. Weights keep torch's
(out_features, in_features) layout. `swiglu_mlp` launches kernel K4
(`csrc/swiglu.cu`) on a CUDA tensor and runs the plain version on a CPU
tensor; its weights are cast to x's dtype for the product (a no-op for
frozen weights, which are stored in it), as the JAX package casts them.
With grad enabled it goes through `SwiGLU`, whose backward is the JAX
package's rematerialising formula (`swiglu_kernel._bwd`) in fp32 on the
weights as given (fp32 masters in mode "full"), the weight gradients in
their dtype.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from dualhyp_tpu_torch.ops import _lib, mid

# K4: replaces dualhyp_tpu/ops/pallas/swiglu_kernel.py `_kernel`. Bound by
# operations in prefill and training, by weight bytes in decode and at a
# verify step's rows. Above MID_ROWS two wgmma products fed by TMA rings:
# the dual gate product writes h = bf16(act(x W1^T) * (x W2^T)) once, the
# down product sums h W3^T over all of `inter` in registers and writes each
# output once (no atomics: bitwise repeatable). Decode rows (<= DECODE_ROWS)
# put the weights on wgmma's 64-row side and split the down product over
# `inter`, summing the partials in a fixed order. From DECODE_ROWS to
# MID_ROWS (a verify step's 72 and 144) two launches of the middle kernel
# (csrc/mid_matmul.cuh, `mid_plan`): the gate with W1's and W2's rows on
# wgmma's M and every token on N (d split over a cluster where the column
# blocks are few, its parts summed on chip before the gate; TinyLlama's 88
# fill the card unsplit); the down product with W3's rows on M,
# `inter` split over a cluster, launched as a programmatic dependent of the
# gate above MID_PDL_ROWS; no fp32 workspace. On an NVIDIA H100 80GB HBM3
# at 700.00 W: 1.064 ms at 8192 rows of TinyLlama (cuBLAS x3 0.860), 0.0645
# at 8, 0.0490 / 0.0548 at 72 / 144 (the row tiles 0.0751 / 0.0786, cuBLAS
# 0.0451 / 0.0498). See the source notes in csrc/swiglu.cu and
# csrc/mid_matmul.cuh.
SWIGLU = _lib.Kernel(
    "dh_swiglu_mlp",
    [_lib.C_PTR] * 7 + [_lib.C_INT] * 10,
)
# rows at or below which K4 takes its decode path (the tokens are wgmma's N,
# at most 64 in the kernel's instances)
DECODE_ROWS = 64
# the most blocks the decode path splits a 64-row slab of W3 over
DECODE_SPLITS = 8
# rows at or below which (above DECODE_ROWS) K4 takes its middle path: a
# verify step's (16 slots x 9 tokens)
MID_ROWS = 144
# rows above which the down launch is a programmatic dependent of the gate
# (it starts streaming W3 while the gate drains): it measured faster at 144
# rows and slower at 72 (NVIDIA H100 80GB HBM3, PERF.md)
MID_PDL_ROWS = 72
PATHS = ("decode", "mid", "rows")  # the kernel's `path` argument
# launches of each path (SWIGLU.launches counts them all)
PATH_LAUNCHES = dict.fromkeys(PATHS, 0)

GATES = ("silu", "gelu")


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def path_of(rows: int) -> str:
    """K4's path at `rows` (`PATHS`): decode up to DECODE_ROWS, mid up to
    MID_ROWS, rows above."""
    if rows <= DECODE_ROWS:
        return "decode"
    return "mid" if rows <= MID_ROWS else "rows"


def mid_plan(rows: int, d: int, inter: int) -> dict:
    """K4's middle path at DECODE_ROWS < `rows` <= MID_ROWS: the gate launch
    (`mid.plan` of x (rows, d) against W1 and W2, 64 of their rows a CTA, d
    split over a cluster) and the down launch (h (rows, inter) against W3,
    128 of its rows a CTA, `inter` split over a cluster), one token tile
    each; `pdl`: the down launch a
    programmatic dependent of the gate, above MID_PDL_ROWS."""
    if not DECODE_ROWS < rows <= MID_ROWS or d % 64 or inter % 8:
        raise ValueError(f"middle rows {rows}, d {d}, inter {inter}")
    gate = mid.plan(rows, inter, d, parts=2)
    down = mid.plan(rows, d, inter)
    return dict(tokens=gate["tokens"], gate=gate, down=down, pdl=rows > MID_PDL_ROWS)


def swiglu_mlp_plain(x, w1, w2, w3, gate: str = "silu"):
    """The plain PyTorch version of K4, in the kernel's arithmetic: the two
    gate products accumulate in fp32, h is rounded to x's dtype, and the
    down projection accumulates in fp32 before the final rounding."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    a = x32 @ w1.to(acc).t()
    b = x32 @ w2.to(acc).t()
    act = F.silu(a) if gate == "silu" else _gelu_tanh(a)
    h = (act * b).to(x.dtype)
    return (h.to(acc) @ w3.to(acc).t()).to(x.dtype)


@contextlib.contextmanager
def _full_fp32_matmuls():
    """fp32 products in full fp32 on the card: TF32 off for the duration (the
    JAX package's backward runs its einsums at Precision.HIGHEST)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def swiglu_mlp_bwd(x, w1, w2, w3, g, gate: str = "silu", needs=(True,) * 4):
    """Gradients of `swiglu_mlp` (`swiglu_kernel._bwd`): the gate is
    recomputed from x in fp32 and every product runs in fp32 with TF32 off.
    `needs` says which of (dx, dw1, dw2, dw3) to compute (frozen weights
    need none: the JAX package's jit drops them as dead code); the others
    come back None."""
    acc = torch.promote_types(x.dtype, torch.float32)
    d = x.shape[-1]
    with _full_fp32_matmuls():
        xd = x.reshape(-1, d).to(acc)
        w1f, w2f, w3f = w1.to(acc), w2.to(acc), w3.to(acc)
        a = xd @ w1f.t()
        b = xd @ w2f.t()
        if gate == "silu":
            sg = torch.sigmoid(a)
            act = a * sg
            dact = sg * (1 + a * (1 - sg))
        else:
            c = math.sqrt(2.0 / math.pi)
            th = torch.tanh(c * (a + 0.044715 * a ** 3))
            act = 0.5 * a * (1.0 + th)
            dact = 0.5 * (1.0 + th) + 0.5 * a * (1.0 - th * th) * c * (
                1.0 + 3 * 0.044715 * a * a)
        g32 = g.reshape(-1, d).to(acc)
        dh = g32 @ w3f
        da = dh * b * dact
        db = dh * act
        dx = dw1 = dw2 = dw3 = None
        if needs[0]:
            dx = (da @ w1f + db @ w2f).to(x.dtype).reshape(x.shape)
        if needs[1]:
            dw1 = (da.t() @ xd).to(w1.dtype)
        if needs[2]:
            dw2 = (db.t() @ xd).to(w2.dtype)
        if needs[3]:
            dw3 = (g32.t() @ (act * b)).to(w3.dtype)
    return dx, dw1, dw2, dw3


class SwiGLU(torch.autograd.Function):
    """K4 forward; the fp32 rematerialising backward in plain PyTorch."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, gate):
        ctx.save_for_backward(x, w1, w2, w3)
        ctx.gate = gate
        return _swiglu(x, w1, w2, w3, gate)

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, w3 = ctx.saved_tensors
        return (*swiglu_mlp_bwd(x, w1, w2, w3, g, ctx.gate, ctx.needs_input_grad[:4]),
                None)


def swiglu_mlp(x, w1, w2, w3, gate: str = "silu"):
    """(act(x @ w1.T) * (x @ w2.T)) @ w3.T with act silu or tanh-gelu.

    x: (..., d); w1, w2: (inter, d); w3: (d, inter), in x's dtype or fp32
    masters (cast to x's dtype for the forward)."""
    if gate not in GATES:
        raise ValueError(f"gate {gate!r} not in {GATES}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, w2, w3)):
        return SwiGLU.apply(x, w1, w2, w3, gate)
    return _swiglu(x, w1, w2, w3, gate)


def _swiglu(x, w1, w2, w3, gate):
    w1, w2, w3 = (w.to(x.dtype) for w in (w1, w2, w3))
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
    # TMA reads contiguous rows from 16-byte aligned bases
    x2, w1, w2, w3 = (_aligned(t) for t in (x.reshape(-1, d), w1, w2, w3))
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    if rows:
        h = torch.empty((rows, inter), dtype=x.dtype, device=device)
        path = path_of(rows)
        partial = (torch.empty((DECODE_SPLITS, d, rows), dtype=torch.float32, device=device)
                   if path == "decode" else None)
        launch = (0,) * 4
        if path == "mid":
            plan = mid_plan(rows, d, inter)
            launch = (plan["tokens"], plan["gate"]["cluster"], plan["down"]["cluster"],
                      int(plan["pdl"]))
        SWIGLU(device, x2.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
               h.data_ptr(), None if partial is None else partial.data_ptr(),
               out.data_ptr(), rows, d, inter, int(gate == "gelu"), DECODE_SPLITS,
               PATHS.index(path), *launch, flops=6 * rows * d * inter)
        PATH_LAUNCHES[path] += 1
    return out.reshape(x.shape)


def _aligned(t):
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def linear(x, w, b=None):
    """Plain torch-layout linear in x's dtype (the JAX package leaves these
    products to XLA; here they go to torch.matmul)."""
    y = x @ w.to(x.dtype).t()
    if b is not None:
        y = y + b.to(x.dtype)
    return y
