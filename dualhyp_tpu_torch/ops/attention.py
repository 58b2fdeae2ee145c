"""Causal grouped-query attention.

Counterpart of `dualhyp_tpu/ops/attention.py`. The scale is 1/sqrt(head
size) and the softmax runs in fp32. K/V carry only the n_query_groups heads;
the grouped broadcast happens inside the kernel or the einsum.

  * `causal_attention`: prefill and full-sequence path. It launches kernel
    K1's forward (`csrc/flash_attention.cu`) on CUDA tensors and runs the
    plain version on CPU tensors.
  * `decode_attention`: one step against the KV cache, masked by each row's
    valid length (plain PyTorch; the JAX package leaves it to XLA too).
"""

from __future__ import annotations

import math

import torch

from dualhyp_tpu_torch.ops import _lib

# K1 forward: replaces dualhyp_tpu/ops/pallas/flash_vjp.py `_fwd_kernel`.
# Bound by operations at long prompts and by q/k/v/o bytes at short ones;
# K/V tiles stream through shared memory, products on the tensor cores,
# online softmax in fp32. See the source note in csrc/flash_attention.cu.
FLASH_FWD = _lib.Kernel(
    "dh_flash_attention_fwd",
    [_lib.C_PTR] * 5 + [_lib.C_INT] * 4 + [_lib.C_F32] + [_lib.C_I64] * 12,
)

FLASH_HEAD_SIZE = 64


def _grouped(q, n_groups):
    b, hq, t, d = q.shape
    return q.reshape(b, n_groups, hq // n_groups, t, d)


def causal_attention_plain(q, k, v, scale: float | None = None):
    """The plain PyTorch version of K1's forward (`_causal_attention_xla` of
    the JAX package): fp32 logits and softmax, probabilities rounded to the
    query dtype before the PV product. Returns (B, Hq, T, D)."""
    b, hq, tq, d = q.shape
    g, tk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = _grouped(q, g).float()
    logits = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * scale
    causal = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)
    logits = logits.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs, v[:, :, None].to(q.dtype))
    return out.reshape(b, hq, tq, d)


def _flash_fwd(q, k, v, scale):
    """Launch K1's forward. Returns (o (B, Hq, T, D) as a view of a
    (B, T, Hq, D) buffer, lse (B, Hq, T) fp32)."""
    device = _lib.check_cuda(q, k, v)
    b, hq, t, d = q.shape
    g = k.shape[1]
    if d != FLASH_HEAD_SIZE:
        raise ValueError(f"flash kernel takes head size {FLASH_HEAD_SIZE}, got {d}")
    if k.shape != (b, g, t, d) or v.shape != (b, g, t, d) or hq % g:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bfloat16 {name}, got {x.dtype}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"flash kernel needs 16-byte aligned rows of {name}: "
                f"strides {x.stride()}")
    o = torch.empty((b, t, hq, d), dtype=q.dtype, device=device).transpose(1, 2)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=device)
    if o.numel():
        FLASH_FWD(device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), b, hq, g, t, float(scale),
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    return o, lse


def causal_attention(q, k, v, scale: float | None = None):
    """q: (B, Hq, T, D); k, v: (B, G, T, D) with G = n_query_groups."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, scale)
    return _flash_fwd(q, k, v, scale)[0]


def decode_attention(q, k_cache, v_cache, kv_length, scale: float | None = None):
    """One decode step against a fixed-size cache.

    q: (B, Hq, 1, D); k_cache, v_cache: (B, G, S, D); kv_length: (B,) valid
    cache slots per row (slots >= kv_length are masked). The logits take
    exact fp32 products of the cached values, the softmax runs in fp32, and
    the probabilities are rounded to q's dtype before the PV product."""
    b, hq, _, d = q.shape
    g, s = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = _grouped(q, g).float()  # (B, G, Qh, 1, D)
    logits = torch.matmul(qg, k_cache.float()[:, :, None].transpose(-1, -2)) * scale
    valid = torch.arange(s, device=q.device)[None, :] < kv_length[:, None]
    logits = logits.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs, v_cache[:, :, None].to(q.dtype))
    return out.reshape(b, hq, 1, d)
