"""Flash-attention forward without a backward: bidirectional and causal.

Counterpart of `dualhyp_tpu/ops/pallas/flash_fwd.py`:

  * `full_attention_fwd`: bidirectional multi-head attention, keys at or
    past `kv_valid` masked. The Whisper encoder's self-attention. It
    launches kernel K6 (`csrc/flash_fwd.cu`) on CUDA tensors and runs
    `full_attention_plain` on CPU tensors.
  * `causal_attention_fwd`: causal grouped-query attention, forward only.
    It launches kernel K7 (the same source, with its causal flag) on CUDA
    tensors and runs `causal_attention_fwd_plain` on CPU tensors.

Both follow the Pallas kernel's arithmetic at every dtype: fp32 logits
from q times the scale in fp32 and k in fp32, an fp32 softmax, and the fp32
probabilities times v upcast to fp32, rounded once (K1's forward,
`attention.causal_attention_plain`, rounds the probabilities to the query
dtype instead). At bf16 the kernels run that fp32 P V as two bf16 products
of P's hi and lo halves; at fp32 every product as six bf16 tensor-core
products of three bf16 pieces of each operand (q times the scale, k, v and
P), which keeps fp32 accuracy. Both take fp32 and bf16, head size 64, and
q, k, v in any (batch, head, token) strides with a unit channel stride and
16-byte aligned rows. The output is a (B, H, T, 64) view of a (B, T, H, 64)
buffer, so `o.transpose(1, 2).reshape(B, T, H * 64)` costs no copy.
"""

from __future__ import annotations

import math

import torch

from dualhyp_tpu_torch.ops import _lib

_ARGS = [_lib.C_PTR] * 4 + [_lib.C_INT] * 6 + [_lib.C_F32] + [_lib.C_I64] * 12

# K6: replaces dualhyp_tpu/ops/pallas/flash_fwd.py `_kernel` as
# `full_attention_fwd` calls it. Bound by operations: fp32 (the encoder's
# dtype) on the tensor cores as six bf16 products of three pieces of each
# operand (split in shared memory; wgmma and TMA), bf16 on L1's forward
# kernel body (wgmma, TMA, P V as hi + lo). Online softmax. On an NVIDIA
# H100 80GB HBM3 at 700.00 W: fp32 0.019 ms at B1 H20 T=S=280 (SDPA 0.037)
# and 0.198 at T=S=1500 (SDPA 0.443), bf16 0.398 at B8 (SDPA 0.255). See
# the source notes in csrc/flash_fwd.cu and csrc/flash_attention.cu.
FLASH_FULL = _lib.Kernel("dh_full_attention_fwd", _ARGS)
# K7: the same `_kernel` as `causal_attention_fwd` calls it (causal=True),
# bf16 on the same body: 0.172 ms at B8 Hq32 G4 T1024 on an NVIDIA H100
# 80GB HBM3 at 700.00 W (SDPA 0.109).
FLASH_CAUSAL = _lib.Kernel("dh_causal_attention_fwd", _ARGS)

HEAD_SIZE = 64


def _attention_plain(q, k, v, scale: float, causal: bool, kv_valid: int | None = None):
    """The Pallas kernel's arithmetic (`flash_fwd._kernel`): fp32 logits from
    q times the scale in fp32 and k in fp32, query i masked from keys j > i
    when `causal` and from keys at or past `kv_valid`, fp32 softmax, fp32
    probabilities times v upcast to fp32, rounded once to q's dtype.
    q: (B, Hq, T, D); k, v: (B, G, S, D), Hq a multiple of G."""
    b, hq, t, d = q.shape
    g, s_len = k.shape[1], k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = (q.to(acc) * scale).reshape(b, g, hq // g, t, d)
    logits = torch.matmul(qg, k.to(acc)[:, :, None].transpose(-1, -2))
    keys = torch.arange(s_len, device=q.device)
    if causal:
        logits = logits.masked_fill(keys > torch.arange(t, device=q.device)[:, None],
                                    float("-inf"))
    if kv_valid is not None and kv_valid < s_len:
        logits = logits.masked_fill(keys >= kv_valid, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.to(acc)[:, :, None]).reshape(q.shape).to(q.dtype)


def full_attention_plain(q, k, v, scale: float | None = None, kv_valid: int | None = None):
    """The plain PyTorch version of K6 (`_attention_plain`, bidirectional,
    keys at or past `kv_valid` masked). q: (B, H, T, D); k, v: (B, H, S, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _attention_plain(q, k, v, scale, causal=False, kv_valid=kv_valid)


def causal_attention_fwd_plain(q, k, v, scale: float | None = None):
    """The plain PyTorch version of K7 (`_attention_plain`, causal, grouped
    query heads). q: (B, Hq, T, D); k, v: (B, G, T, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _attention_plain(q, k, v, scale, causal=True)


def _check(q, k, v, causal: bool):
    b, hq, t, d = q.shape
    g, s_len = k.shape[1], k.shape[2]
    if d != HEAD_SIZE:
        raise ValueError(f"flash_fwd kernel takes head size {HEAD_SIZE}, got {d}")
    if (k.shape != (b, g, s_len, d) or v.shape != k.shape or hq % g
            or (causal and s_len != t) or (not causal and g != hq)):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"({'causal' if causal else 'full'} attention)")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd kernel takes fp32 or bf16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"flash_fwd kernel needs 16-byte aligned rows of {name}: strides {x.stride()}")


def _launch(kernel, q, k, v, scale: float, s_valid: int, causal: bool):
    device = _lib.check_cuda(q, k, v)
    _check(q, k, v, causal)
    b, hq, t, d = q.shape
    o = torch.empty((b, t, hq, d), dtype=q.dtype, device=device).transpose(1, 2)
    if o.numel():
        kernel(device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               b, hq, k.shape[1], t, s_valid, _lib.dtype_code(q), float(scale),
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
               flops=4 * b * hq * t * k.shape[2] * d)
    return o


def full_attention_fwd(q, k, v, scale: float | None = None, kv_valid: int | None = None):
    """Bidirectional attention. q: (B, H, T, 64); k, v: (B, H, S, 64), S may
    differ from T; keys at or past `kv_valid` (default S) are masked.
    Returns (B, H, T, 64) in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return full_attention_plain(q, k, v, scale, kv_valid)
    s_len = k.shape[2]
    s_valid = s_len if kv_valid is None else min(int(kv_valid), s_len)
    if s_valid < 1 and q.numel():
        raise ValueError(f"kv_valid {kv_valid}: no key to attend")
    return _launch(FLASH_FULL, q, k, v, scale, s_valid, causal=False)


def causal_attention_fwd(q, k, v, scale: float | None = None):
    """Causal grouped-query attention, forward only. q: (B, Hq, T, 64); k, v:
    (B, G, T, 64), Hq a multiple of G. Returns (B, Hq, T, 64)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return causal_attention_fwd_plain(q, k, v, scale)
    return _launch(FLASH_CAUSAL, q, k, v, scale, k.shape[2], causal=True)
