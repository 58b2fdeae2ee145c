"""L1: splash attention, causal grouped-query attention with its own forward,
dQ and dK/dV kernels.

Counterpart of `dualhyp_tpu/ops/pallas/flash_attention.py`, which runs the
splash-attention library kernels of jax.experimental.pallas
(`make_splash_mqa_single_device` per batch and KV group) and is chosen by
`DUALHYP_ATTN_IMPL=splash` (`ops/attention.causal_attention`). It follows
the splash arithmetic, which differs from K1's:

  * at T >= 128 with T % 128 == 0 (the JAX wrapper's alignment), q is
    scaled and rounded to its dtype before the kernels, q_hat = q *
    tensor(scale, q.dtype): in bf16 the scale itself rounds (at D=128,
    0.08837890625 for 0.0883883...); the kernels then run with scale 1, and
    autograd of the multiply gives dq = dq_hat * the same rounded scale;
  * at other T the JAX package runs its XLA path (fp32 logits times the
    scale); the port launches the same kernels there, with the raw q, the
    scale inside the kernel and the ragged tail masked;
  * the forward multiplies the fp32 P by V upcast to fp32 (K1 rounds P to
    bf16) and keeps the row logsumexp; dQ rounds dS to k's dtype before dS
    K; dK/dV round P and dS to dO's dtype before P^T dO and dS^T q, and sum
    over the q_per_kv heads of each KV group.

On CPU tensors each wrapper runs its plain version (`splash_fwd_plain`,
`splash_dq_plain`, `splash_dkv_plain`); on CUDA tensors it launches its
kernel (`csrc/flash_attention.cu` for the forward,
`csrc/flash_attention_bwd.cu` for dQ and dK/dV) or raises.
"""

from __future__ import annotations

import math

import torch

from dualhyp_tpu_torch.ops import _lib
from dualhyp_tpu_torch.ops.attention import (FLASH_HEAD_SIZES, _acc_dtype, _aligned_rows,
                                             _grouped, _masked_logits, _pad_heads,
                                             padded_head_size)
from dualhyp_tpu_torch.ops.swiglu import _aligned

# L1 forward: replaces splash_attention_kernel.py `flash_attention_kernel`
# (pallas_call :1137). Bound by operations (2 products a causal pair, the PV
# product done as two bf16 products of P's hi and lo halves). It is K1's
# forward kernel body (csrc/flash_attention.cu, `splash_fwd`): a producer
# warp streams K/V tiles by TMA, consumer warpgroups run QK^T on wgmma, the
# online softmax in registers and P V as two register-A wgmma products of
# P's hi and lo halves; the longest query tiles first. On an NVIDIA H100
# 80GB HBM3 at 700.00 W: 0.147 ms at B8 Hq32 G4 T1024 D64 (SDPA 0.109),
# 0.248 at G8 D128 (SDPA 0.148).
SPLASH_FWD = _lib.Kernel(
    "dh_splash_fwd", [_lib.C_PTR] * 5 + [_lib.C_INT] * 5 + [_lib.C_F32] + [_lib.C_I64] * 12)

# L1 dQ: replaces `_flash_attention_dq_kernel` (pallas_call :1635). Bound by
# operations (3 products a causal pair). Shaped like K1's forward
# (csrc/flash_attention_bwd.cu, `splash_dq`): a block owns 64 query rows of
# one head, a producer warp streams the K/V tiles at or below the diagonal
# by TMA, a consumer warpgroup runs S = Q K^T and dP = dO V^T on wgmma and
# dQ += bf16(dS) K with dS as the register A operand; dQ stays in registers
# and is written once, with no atomics.
SPLASH_DQ = _lib.Kernel(
    "dh_splash_dq", [_lib.C_PTR] * 7 + [_lib.C_INT] * 5 + [_lib.C_F32] + [_lib.C_I64] * 15)

# L1 dK/dV: replaces `_flash_attention_dkv_kernel` (pallas_call :2196). Bound
# by operations (4 products a causal pair). K1's backward kernel body
# without its dQ half (csrc/flash_attention_bwd.cu, `splash_dkv`): a block
# owns (batch, KV group, 64 or 128 keys), a producer warpgroup streams every
# group head's Q, dO, lse and di tiles by TMA, and dK and dV, summed over
# the group's heads on wgmma, stay in registers and are written once.
SPLASH_DKV = _lib.Kernel(
    "dh_splash_dkv", [_lib.C_PTR] * 9 + [_lib.C_INT] * 5 + [_lib.C_F32] + [_lib.C_I64] * 18)

# head sizes the kernels take: K1's, every one of the model registry (100
# on a copy padded with zero columns to 104, as K1 reads it)
HEAD_SIZES = FLASH_HEAD_SIZES
# the JAX wrapper runs the splash kernel at T >= 128 with T % 128 == 0
# (`flash_attention.py:56`) and XLA elsewhere
MIN_SEQ = 128


def aligned(t: int) -> bool:
    """Whether the JAX wrapper runs its splash kernel at sequence length t."""
    return t >= MIN_SEQ and t % MIN_SEQ == 0


def splash_fwd_plain(q, k, v, scale: float = 1.0):
    """The plain version of L1's forward: fp32 logits times `scale`, causal
    mask, fp32 P = exp(S - lse) times V upcast, O in q's dtype. q: (B, Hq,
    T, D); k, v: (B, G, T, D). Returns (o (B, Hq, T, D), lse (B, Hq, T)
    fp32)."""
    b, hq, t = q.shape[:3]
    logits = _masked_logits(q, k, scale)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - lse)
    o = torch.matmul(p, v.to(p.dtype)[:, :, None])
    return o.reshape(q.shape).to(q.dtype), lse.reshape(b, hq, t).to(_acc_dtype(q.dtype))


def _p_and_dp(q, k, v, lse, do, scale):
    """p = exp(S - lse) and dP = dO V^T (dO in v's dtype, fp32 sums), both
    (B, G, q_per_kv, T, T) in the accumulation dtype."""
    b, hq, t, _ = q.shape
    g = k.shape[1]
    acc = _acc_dtype(q.dtype)
    p = torch.exp(_masked_logits(q, k, scale) - lse.reshape(b, g, hq // g, t, 1).to(acc))
    dp = torch.matmul(_grouped(do.to(v.dtype), g).to(acc),
                      v.to(acc)[:, :, None].transpose(-1, -2))
    return p, dp


def splash_dq_plain(q, k, v, lse, do, di, scale: float = 1.0):
    """The plain version of L1's dQ: dS = p (dP - di), dQ = scale * bf16(dS)
    K (dS rounded to k's dtype), in q's dtype. lse, di: (B, Hq, T) fp32."""
    b, hq, t = q.shape[:3]
    g = k.shape[1]
    acc = _acc_dtype(q.dtype)
    p, dp = _p_and_dp(q, k, v, lse, do, scale)
    ds = p * (dp - di.reshape(b, g, hq // g, t, 1).to(acc))
    dq = torch.matmul(ds.to(k.dtype).to(acc), k.to(acc)[:, :, None]) * scale
    return dq.reshape(q.shape).to(q.dtype)


def splash_dkv_plain(q, k, v, lse, do, di, scale: float = 1.0):
    """The plain version of L1's dK/dV: dV = sum over the group's heads of
    bf16(p)^T dO, dK = scale * sum of bf16(dS)^T q (P and dS rounded to
    dO's dtype), in the dtypes of k and v."""
    b, hq, t = q.shape[:3]
    g = k.shape[1]
    acc = _acc_dtype(q.dtype)
    p, dp = _p_and_dp(q, k, v, lse, do, scale)
    ds = p * (dp - di.reshape(b, g, hq // g, t, 1).to(acc))
    dog = _grouped(do, g)
    dv = torch.matmul(p.to(do.dtype).to(acc).transpose(-1, -2), dog.to(acc)).sum(2)
    dk = torch.matmul(ds.to(do.dtype).to(acc).transpose(-1, -2),
                      _grouped(q, g).to(acc)).sum(2) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _check(names_tensors, lse_like=()):
    for name, x in names_tensors:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"splash kernel takes bfloat16 {name}, got {x.dtype}")
        if not _aligned_rows(x):
            raise ValueError(
                f"splash kernel needs 16-byte aligned rows of {name}: strides {x.stride()}")
    for name, x in lse_like:
        if x.dtype != torch.float32:
            raise TypeError(f"splash kernel takes fp32 {name}, got {x.dtype}")


def _check_shapes(q, k, v, *same_as_q):
    b, hq, t, d = q.shape
    g = k.shape[1]
    if d not in HEAD_SIZES:
        raise ValueError(f"splash kernel takes head size {HEAD_SIZES}, got {d}")
    if (k.shape != (b, g, t, d) or v.shape != (b, g, t, d) or hq % g
            or any(x.shape != q.shape for x in same_as_q)):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"{[tuple(x.shape) for x in same_as_q]}")


def _tma_readable(x, dp: int | None = None):
    """x itself when TMA can read it (16-byte aligned base, unit channel
    stride, other strides multiples of 16 bytes, dp channels: x's own when
    None), else a contiguous, aligned copy (padded with zero channels to
    dp)."""
    if dp is not None and x.shape[-1] != dp:
        return _pad_heads(x, dp)
    return x if _aligned_rows(x) else _aligned(x)


def splash_fwd(q, k, v, scale: float = 1.0):
    """Launch L1's forward. q: (B, Hq, T, D); k, v: (B, G, T, D), bf16, D of
    `HEAD_SIZES`, any (batch, head, token) strides with a unit channel stride; an
    input TMA cannot read as it lies is copied first. Returns (o (B, Hq, T,
    D) as a view of a (B, T, Hq, D) buffer, lse (B, Hq, T) fp32)."""
    device = _lib.check_cuda(q, k, v)
    _check_shapes(q, k, v)
    d = q.shape[-1]
    dp = padded_head_size(d)
    q, k, v = (_tma_readable(x, dp) for x in (q, k, v))
    _check((("q", q), ("k", k), ("v", v)))
    b, hq, t, _ = q.shape
    o = torch.empty((b, t, hq, dp), dtype=q.dtype, device=device).transpose(1, 2)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=device)
    if o.numel():
        SPLASH_FWD(device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), b, hq, k.shape[1], t, dp, float(scale),
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                   flops=4 * b * hq * t * t * d)
    return o[..., :d], lse


def _bwd_inputs(q, k, v, lse, do, di):
    device = _lib.check_cuda(q, k, v, lse, do, di)
    _check_shapes(q, k, v, do)
    b, hq, t, _ = q.shape
    if lse.shape != (b, hq, t) or di.shape != (b, hq, t):
        raise ValueError(f"lse {tuple(lse.shape)}, di {tuple(di.shape)}: want {(b, hq, t)}")
    dp = padded_head_size(q.shape[-1])
    if dp != q.shape[-1]:
        q, k, v, do = (_pad_heads(x, dp) for x in (q, k, v, do))
    if not _aligned_rows(do):
        do = do.contiguous()
    _check((("q", q), ("k", k), ("v", v), ("do", do)), (("lse", lse), ("di", di)))
    return device, q, k, v, do, lse.contiguous(), di.contiguous()


def splash_dq(q, k, v, lse, do, di, scale: float = 1.0):
    """Launch L1's dQ kernel. q, do: (B, Hq, T, D); k, v: (B, G, T, D), bf16
    (dO as autograd hands it: copied only when its rows are not aligned);
    lse, di: (B, Hq, T) fp32. Returns dq (B, Hq, T, D) in q's dtype."""
    d = q.shape[-1]
    device, q, k, v, do, lse, di = _bwd_inputs(q, k, v, lse, do, di)
    b, hq, t, dp = q.shape
    dq = torch.empty((b, hq, t, dp), dtype=q.dtype, device=device)
    if dq.numel():
        SPLASH_DQ(device, q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                  do.data_ptr(), di.data_ptr(), dq.data_ptr(), b, hq, k.shape[1], t, dp,
                  float(scale), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *do.stride()[:3], *dq.stride()[:3], flops=6 * b * hq * t * t * d)
    return dq[..., :d]


def splash_dkv(q, k, v, lse, do, di, scale: float = 1.0):
    """Launch L1's dK/dV kernel (inputs as `splash_dq`). Returns (dk, dv),
    (B, G, T, D) in the dtypes of k and v, summed over each group's heads."""
    d = q.shape[-1]
    device, q, k, v, do, lse, di = _bwd_inputs(q, k, v, lse, do, di)
    b, hq, t, dp = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=device)
    # lse and di, each (B, Hq, T rounded up to 64): whole 64-row TMA boxes
    rows = torch.empty((2, b, hq, -(-t // 64) * 64), dtype=torch.float32, device=device)
    if dk.numel():
        SPLASH_DKV(device, q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                   do.data_ptr(), di.data_ptr(), rows.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), b, hq, k.shape[1], t, dp, float(scale), *q.stride()[:3],
                   *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], *dk.stride()[:3],
                   *dv.stride()[:3], flops=8 * b * hq * t * t * d)
    return dk[..., :d], dv[..., :d]


def row_dot(o, do):
    """di = rowsum(fp32 O * fp32 dO), (B, Hq, T): what splash computes
    outside its kernels (`splash_attention_kernel.py:2285`)."""
    acc = _acc_dtype(o.dtype)
    return (o.to(acc) * do.to(acc)).sum(-1)


class SplashAttention(torch.autograd.Function):
    """Causal GQA attention with L1's forward, dQ and dK/dV (the custom VJP
    of splash attention). The forward saves (q, k, v, o, lse); on CPU
    tensors it runs the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        fwd = splash_fwd_plain if q.device.type == "cpu" else splash_fwd
        o, lse = fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        cpu = q.device.type == "cpu"
        di = row_dot(o, do)
        dq = (splash_dq_plain if cpu else splash_dq)(q, k, v, lse, do, di, ctx.scale)
        dk, dv = (splash_dkv_plain if cpu else splash_dkv)(q, k, v, lse, do, di, ctx.scale)
        return dq, dk, dv, None


def causal_attention(q, k, v, scale: float | None = None):
    """q: (B, Hq, T, D); k, v: (B, G, T, D), with the semantics of the JAX
    `flash_attention.causal_attention`: at aligned T, q_hat = q * the scale
    rounded to q's dtype and the kernels at scale 1; elsewhere the raw q and
    the scale in the kernels. With grad enabled and an input that needs it,
    the autograd op `SplashAttention`; else the forward alone."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if aligned(q.shape[2]):
        q = q * torch.tensor(scale, dtype=q.dtype)
        scale = 1.0
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return SplashAttention.apply(q, k, v, scale)
    if q.device.type == "cpu":
        return splash_fwd_plain(q, k, v, scale)[0]
    return splash_fwd(q, k, v, scale)[0]
