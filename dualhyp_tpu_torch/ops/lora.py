"""The fused LoRA linear: kernel K5.

Counterpart of `dualhyp_tpu/ops/pallas/lora_kernel.py`:
y = x W^T + s * (xin A^T) B^T in one kernel, where xin is the LoRA branch's
input (x after dropout, or x itself) and s = lora_scaling times the
`lora_start_layer` gate. `lora_linear` launches K5 (`csrc/lora_linear.cu`)
on a CUDA tensor and runs `lora_linear_plain` on a CPU tensor. With grad
enabled it goes through `LoRALinear`, whose backward is the JAX package's
`_bwd` in plain PyTorch (the JAX package leaves it to XLA, outside any
kernel): dx, dxin, dA and dB, no dW (the base weight is frozen).
"""

from __future__ import annotations

import functools

import torch

from dualhyp_tpu_torch.ops import _lib, mid
from dualhyp_tpu_torch.ops.swiglu import _full_fp32_matmuls

# K5: replaces dualhyp_tpu/ops/pallas/lora_kernel.py `_kernel`. Bound by the
# base product's operations at prefill and training rows and by W's bytes at
# decode and verify rows; the (rows, O) intermediate stays on chip. Above
# MID_ROWS rows two wgmma/TMA kernels: h = bf16(xin A^T) into an (rows,
# r_pad) scratch, then 128 x 256 tiles of x W^T with h B^T added in the
# epilogue, s folded into the base sum. From DECODE_ROWS to MID_ROWS (a
# verify step's 36-144) one launch of the middle kernel (csrc/mid_matmul.cuh,
# `mid_plan`): every token on wgmma's N, 128 rows of W and A's r rows on its
# M, D split over a cluster whose parts meet on chip, xin A^T summed over
# all of D before it is rounded, acc + s * delta rounded once. At decode
# rows one kernel streams W and A into mma.sync fragments with 16-byte
# loads, its CTAs in clusters that split D (`decode_plan`). No tensor map
# below MID_ROWS. On an NVIDIA H100 80GB HBM3 at 700.00 W: 0.0775 ms at
# 3072 rows of the fused QKV (cuBLAS x3 + add 0.112), 0.1747 at 8192; at a
# verify step's 36 / 72 / 144 rows 0.0165 / 0.0190 / 0.0261 (the wgmma pair
# 0.0376 / 0.0388 / 0.0409, cuBLAS 0.0268 / 0.0284 / 0.0276). See the source
# notes in csrc/lora_linear.cu and csrc/mid_matmul.cuh.
LORA_LINEAR = _lib.Kernel(
    "dh_lora_linear",
    [_lib.C_PTR] * 7 + [_lib.C_F32] + [_lib.C_INT] * 7,
)

MAX_RANK = 64  # the kernel's largest padded rank
# rows at or below which the decode kernel runs, above it the middle kernel:
# its most, below which it took less device and host time than the wgmma
# kernels at every count measured (1 to 32 rows, PERF.md)
DECODE_ROWS = 32
DECODE_COLS = 128  # output columns a CTA of the decode kernel: 8 warps of 16
DECODE_STEP = 32  # depth of the decode kernel's steps over D
# rows at or below which (above DECODE_ROWS) the middle kernel runs: past a
# verify step's 144 (16 slots x 9 tokens), as far as it beat the wgmma pair
# at the fused QKV, proj and both MLP shapes (192 rows, two token tiles of
# 96; at 256 it tied at the MLP's fc; NVIDIA H100 80GB HBM3, PERF.md)
MID_ROWS = 192
PATHS = ("decode", "mid", "wgmma")  # the kernel's `path` argument
# launches of each path (LORA_LINEAR.launches counts them all)
PATH_LAUNCHES = dict.fromkeys(PATHS, 0)
MAX_CLUSTER = 8
FILL_CTAS = 3 * 132  # CTAs the card holds at once: three an SM of the H100's 132
SMEM_LIMIT = 232448  # shared memory a CTA may take on an H100 (227 KB)


@functools.lru_cache(maxsize=None)
def decode_cluster(rows: int, o: int, d: int, rank_tiles: int, separate: bool) -> tuple:
    """(cluster, CTAs, shared memory bytes a CTA) of K5's decode kernel at
    `rows` <= DECODE_ROWS with `rank_tiles` warps over A (`decode_plan`); raises
    where D's slice of x would not fit a CTA's shared memory."""
    if not 0 < rows <= DECODE_ROWS or d % 8 or o < 1:
        raise ValueError(f"decode rows {rows}, O {o}, D {d}")
    steps = -(-d // DECODE_STEP)
    blocks = -(-o // DECODE_COLS)
    cluster = 1
    while cluster < MAX_CLUSTER and 2 * blocks * cluster <= FILL_CTAS and 2 * cluster <= steps:
        cluster *= 2
    per = -(-steps // cluster)
    ldxs = (per + 1) // 2 * 2 * DECODE_STEP + 32
    smem = (8 * -(-rows // 8) * (ldxs * 2 * (2 if separate and rank_tiles else 1)
                                 + DECODE_COLS * 4 + 16 * rank_tiles * 4 * (cluster + 1))
            + DECODE_COLS // cluster * 16 * rank_tiles * 2)
    if smem > SMEM_LIMIT:
        raise ValueError(f"D {d} takes {smem} bytes of shared memory a CTA at {rows} rows")
    return cluster, blocks * cluster, smem


def decode_plan(rows: int, o: int, d: int, r: int, s: float = 1.0,
                separate: bool = False) -> dict:
    """The launch of K5's decode kernel at `rows` <= DECODE_ROWS: CTAs of DECODE_COLS
    output columns (8 warps over W's rows, and one warp a 16 rows of A
    unless s is 0), `cluster` of them a column block, each taking an even
    share of D's 32-deep steps (`steps[rank]`); the cluster's CTAs add
    their fp32 parts of xin A^T in shared memory in rank order, each CTA
    all of them (then rounds to bf16), and the base parts of
    `columns[rank]` of the block. The cluster is the largest power of two,
    at most MAX_CLUSTER and the step count, whose CTAs the card holds at
    once (FILL_CTAS). `smem`: its bytes a CTA (x and xin staged once, the
    cluster's parts of its columns and of xin A^T, bf16(xin A^T), B's
    rows)."""
    if not 0 < r <= MAX_RANK:
        raise ValueError(f"rank {r}")
    rank_tiles = 0 if s == 0 else -(-r // 16)
    cluster, ctas, smem = decode_cluster(rows, o, d, rank_tiles, separate)
    steps = -(-d // DECODE_STEP)
    cols = DECODE_COLS // cluster
    return dict(token_tiles=-(-rows // 8), rank_tiles=rank_tiles, col_blocks=ctas // cluster,
                cluster=cluster, ctas=ctas, threads=32 * (8 + rank_tiles), smem=smem,
                steps=[(c * steps // cluster, (c + 1) * steps // cluster)
                       for c in range(cluster)],
                columns=[(c * cols, (c + 1) * cols) for c in range(cluster)])


def path_of(rows: int) -> str:
    """K5's path at `rows` (`PATHS`): decode up to DECODE_ROWS, mid up to
    MID_ROWS, wgmma above."""
    if rows <= DECODE_ROWS:
        return "decode"
    return "mid" if rows <= MID_ROWS else "wgmma"


def mid_plan(rows: int, o: int, d: int, r: int, s: float = 1.0,
             separate: bool = False) -> dict:
    """The launch of K5's middle kernel at DECODE_ROWS < `rows` <= MID_ROWS
    (`mid.plan`): token tiles of at most 144 (one to 144 rows, each
    streaming W), column blocks of 128 output columns, D's 64-deep steps
    split over a cluster; at s = 0 no A tile (the branch is skipped), else
    A's r rows (padded to 8, as the wrapper pads A and B) over x or a
    separate xin."""
    if not DECODE_ROWS < rows <= MID_ROWS or d % 8 or not 0 < r <= MAX_RANK:
        raise ValueError(f"middle rows {rows}, O {o}, D {d}, rank {r}")
    rank = s != 0
    return mid.plan(rows, o, d, rank=rank, sep=rank and separate,
                    r=-(-r // 8) * 8 if rank else 0)


def lora_linear_plain(x, w, a, b, s, xin=None):
    """The plain PyTorch version of K5, in the fused kernel's arithmetic: the
    base product and xin A^T each summed in fp32; the (rows, r) result
    rounded to x's dtype, then multiplied by B^T in fp32; acc + s * delta
    rounded once. (`gpt.Linear`'s composition rounds after every product.)"""
    acc_t = torch.promote_types(x.dtype, torch.float32)
    xin = x if xin is None else xin
    w, a, b = (t.to(x.dtype).to(acc_t) for t in (w, a, b))
    base = x.to(acc_t) @ w.t()
    h = (xin.to(acc_t) @ a.t()).to(x.dtype).to(acc_t)
    return (base + s * (h @ b.t())).to(x.dtype)


def lora_qkv_block_b(b, shapes, r: int):
    """The fused-QKV LoRA B (sum(shapes), r) as one block-diagonal
    (sum(shapes), len(shapes) * r) matrix, so the [q | k | v] delta is one
    product of rank len(shapes) * r."""
    blocks = []
    row = 0
    for extent in shapes:
        blocks.append(b[row:row + extent])
        row += extent
    return torch.block_diag(*blocks)


def _launch(x, xin, w, a, b, s):
    device = _lib.check_cuda(x, w, a, b, *(() if xin is None else (xin,)))
    d = x.shape[-1]
    o, r = b.shape
    if w.shape != (o, d) or a.shape != (r, d) or (xin is not None and xin.shape != x.shape):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}"
                         + ("" if xin is None else f", xin {tuple(xin.shape)}"))
    for t in (x, w, a, b, *(() if xin is None else (xin,))):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"lora kernel takes bfloat16, got {t.dtype}")
    if d % 8 or not 0 < r <= MAX_RANK:
        raise ValueError(f"lora kernel needs in_features % 8 == 0 and 0 < rank <= "
                         f"{MAX_RANK}, got {d}, {r}")
    x2 = _aligned(x.reshape(-1, d))
    xin2 = x2 if xin is None else _aligned(xin.reshape(-1, d))
    w, a, b = _aligned(w), _aligned(a), _aligned(b)
    rows = x2.shape[0]
    out = torch.empty((rows, o), dtype=x.dtype, device=device)
    if not rows or not o:
        return out.reshape(*x.shape[:-1], o)
    h, ranks, tokens = None, 0, 0
    path = path_of(rows)
    if path == "decode":  # one launch, no scratch: D's split meets on chip
        ranks = decode_cluster(rows, o, d, 0 if s == 0 else -(-r // 16), xin is not None)[0]
    else:
        if r % 8:  # whole 16-byte rows of A and B: zeros to a multiple of 8
            pad = -r % 8
            a = torch.nn.functional.pad(a, (0, 0, 0, pad))
            b = torch.nn.functional.pad(b, (0, pad))
            r += pad
        if path == "mid":  # one launch, no scratch: D's split meets on chip
            plan = mid_plan(rows, o, d, r, s, xin is not None)
            ranks, tokens = plan["cluster"], plan["tokens"]
        else:  # the wgmma kernels and their (rows, r_pad) scratch
            h = torch.empty((rows, -(-r // 16) * 16), dtype=x.dtype, device=device)
    LORA_LINEAR(device, x2.data_ptr(), xin2.data_ptr(), w.data_ptr(), a.data_ptr(),
                b.data_ptr(), 0 if h is None else h.data_ptr(), out.data_ptr(),
                float(s), rows, o, d, r, PATHS.index(path), ranks, tokens,
                flops=2 * rows * (o * d + r * d + o * r))
    PATH_LAUNCHES[path] += 1
    return out.reshape(*x.shape[:-1], o)


def _aligned(t):
    """`t` contiguous and 16-byte aligned (a copy only where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(x, xin, w, a, b, s):
    if x.device.type == "cpu":
        return lora_linear_plain(x, w, a, b, s, xin)
    return _launch(x, xin, w, a, b, s)


class LoRALinear(torch.autograd.Function):
    """K5 forward; the JAX package's `_bwd` in plain PyTorch. w, a and b come
    in x's dtype (the caller casts the fp32 LoRA masters, and autograd casts
    their gradients back); dA and dB are summed in fp32, multiplied by s,
    then rounded to that dtype, as in JAX."""

    @staticmethod
    def forward(ctx, x, xin, w, a, b, s):
        ctx.save_for_backward(x, xin, w, a, b)
        ctx.s = s
        return _forward(x, xin, w, a, b, s)

    @staticmethod
    def backward(ctx, g):
        x, xin, w, a, b = ctx.saved_tensors
        s = ctx.s
        d, o = x.shape[-1], w.shape[0]
        dy = g.to(x.dtype).reshape(-1, o)
        x2 = x.reshape(-1, d)
        xin2 = x2 if xin is None else xin.reshape(-1, d)
        dy_b = dy @ b  # (rows, r)
        dx = dy @ w if ctx.needs_input_grad[0] else None
        dxin = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            # s rounded to dy's dtype, as the JAX product's; a CPU scalar
            # tensor: one made on the card from a Python number would copy
            # it there and hold the host until the card caught up, every call
            dxin = torch.tensor(s, dtype=dy.dtype) * (dy_b @ a)
        da = db = None
        acc_t = torch.promote_types(dy.dtype, torch.float32)
        with _full_fp32_matmuls():
            if ctx.needs_input_grad[3]:
                da = (s * (dy_b.to(acc_t).t() @ xin2.to(acc_t))).to(a.dtype)
            if ctx.needs_input_grad[4]:
                h = xin2 @ a.t()  # (rows, r), recomputed
                db = (s * (dy.to(acc_t).t() @ h.to(acc_t))).to(b.dtype)
        dxin_out = None
        if xin is None:
            if dx is not None:
                dx = dx + dxin
        else:
            dxin_out = dxin.reshape(xin.shape) if ctx.needs_input_grad[1] else None
        if dx is not None:
            dx = dx.reshape(x.shape)
        return dx, dxin_out, None, da, db, None


def lora_linear(x, w, a, b, s, *, xin=None):
    """x W^T + s * (xin A^T) B^T. x: (..., D); w: (O, D); a: (r, D); b:
    (O, r); s a float (LoRA scaling times the layer gate). xin: the branch's
    input, x when None (read once). w, a and b are cast to x's dtype, as the
    JAX package casts them before its kernel."""
    w, a, b = (t.to(x.dtype) for t in (w, a, b))
    s = float(s)
    tensors = (x, w, a, b) if xin is None else (x, xin, w, a, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return LoRALinear.apply(x, xin, w, a, b, s)
    return _forward(x, xin, w, a, b, s)
