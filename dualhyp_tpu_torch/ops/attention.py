"""Causal grouped-query attention.

Counterpart of `dualhyp_tpu/ops/attention.py`. The scale is 1/sqrt(head
size) and the softmax runs in fp32. K/V carry only the n_query_groups heads;
the grouped broadcast happens inside the kernel or the einsum.

  * `causal_attention`: prefill and full-sequence path. It reads
    `DUALHYP_ATTN_IMPL` at each call, as the JAX package does: "own" (the
    default) launches kernel K1's forward (`csrc/flash_attention.cu`) on
    CUDA tensors and runs the plain version on CPU tensors; with grad
    enabled it goes through `FlashAttention`, whose backward launches K1's
    backward (`csrc/flash_attention_bwd.cu`), or runs the plain pair on the
    CPU. Any other value ("splash") runs L1, `ops/splash.causal_attention`:
    its own forward (`csrc/flash_attention.cu`), dQ and dK/dV kernels
    (`csrc/flash_attention_bwd.cu`).
    All take every head size of the model registry (`FLASH_HEAD_SIZES`:
    32, 64, 80, 96, 100, 128, 256); head size 100 runs on a copy of its
    inputs padded with zero columns to 104 (`padded_head_size`), since a
    200-byte row breaks TMA's 16-byte stride rule.
  * `chunk_decode_attention`: a speculative verify step's K queries a row
    against the KV cache, query i masked to the slots at or below start +
    i, with the per-slot scales of an int8 cache (plain PyTorch; the JAX
    package leaves it to XLA too); `decode_attention` is its K = 1 case,
    one step masked by each row's valid length.
"""

from __future__ import annotations

import math
import os

import torch

from dualhyp_tpu_torch.ops import _lib

# K1 forward: replaces dualhyp_tpu/ops/pallas/flash_vjp.py `_fwd_kernel`.
# Bound by operations at long prompts and by q/k/v/o bytes at short ones.
# A producer warp streams K/V tiles by TMA (4-D tensor maps over the strided
# views, encoded at each call) through an mbarrier ring; consumer warpgroups
# run QK^T and PV on wgmma with S, P and O in registers and the online
# softmax in fp32; one instance per head size of the model registry, a size
# that is not a multiple of 64 reading whole 64-column boxes zero-filled
# past D. On an NVIDIA H100 80GB HBM3 at 700.00 W: 0.147 ms at B8 Hq32 G4
# T1024 D64 (SDPA 0.112), 0.229 at G8 D128 (SDPA 0.148); the other head
# sizes in PERF.md. See the source note in csrc/flash_attention.cu.
FLASH_FWD = _lib.Kernel(
    "dh_flash_attention_fwd",
    [_lib.C_PTR] * 5 + [_lib.C_INT] * 5 + [_lib.C_F32] + [_lib.C_I64] * 12,
)

# K1 backward: replaces dualhyp_tpu/ops/pallas/flash_vjp.py `_bwd_kernel`.
# Bound by operations (five products per causal pair). A pre-pass writes
# Delta and a copy of L, padded to 64 rows, into a scratch; one block per
# (batch, KV group, key block) keeps dK/dV in registers and sums the group's
# heads there; a producer warpgroup streams the query tiles' Q, dO, L and
# Delta by TMA through an mbarrier ring; consumer warpgroups of 64 keys run
# S^T, dP^T, dV, dK and dQ on wgmma (P^T and dS^T as register A operands;
# dS^T through shared memory for dQ) and add each pair's fp32 dQ tile by
# TMA reduce-adds, with no per-element atomics; one instance per head size
# (`bwd_layout`: 128 keys a block at D32 to D96, 64 at D100 and D128; at
# D80 and D96 the columns past 64 in a narrow box of their own, the loads
# issued by a consumer thread and the two warpgroups' dQ added in shared
# memory before one reduce-add; at D256 dK/dV split over two blocks by
# columns and dQ from L1's dQ kernel into the same fp32 buffer, all with
# K1's exp2f). On an NVIDIA H100 80GB HBM3 at 700.00 W: 0.466 ms at B8 Hq32
# G4 T1024 D64 (SDPA's backward 0.42-0.64), 1.257 at G8 D128 (SDPA 0.667);
# the other head sizes in PERF.md. See csrc/flash_attention_bwd.cu.
FLASH_BWD = _lib.Kernel(
    "dh_flash_attention_bwd",
    [_lib.C_PTR] * 10 + [_lib.C_INT] * 5 + [_lib.C_F32] + [_lib.C_I64] * 21,
)

# head sizes K1's forward and backward take: every one of the model
# registry (pythia-14m 32, TinyLlama 64, phi-2 80, Phi-3 96, open_llama_3b
# 100, LLaMA and Mixtral 128, Gemma 256)
FLASH_HEAD_SIZES = (32, 64, 80, 96, 100, 128, 256)
# launches of K1's backward at each head size (FLASH_BWD.launches counts
# them all): a run reads them to show which instance its calls took
BWD_HEAD_LAUNCHES = dict.fromkeys(FLASH_HEAD_SIZES, 0)
# head sizes whose rows the kernels read from a copy padded with zero
# columns (the pad leaves S = q k^T and P V exact; the wrapper drops it)
_PADDED = {100: 104}


def padded_head_size(d: int) -> int:
    """The row width the kernels read for head size d."""
    return _PADDED.get(d, d)


def bwd_layout(d: int) -> dict:
    """The instance of K1's backward (and L1's dK/dV) that head size d runs,
    as csrc/flash_attention_bwd.cu lays it out: the row width it reads
    (`instance`), consumer `warpgroups` of 64 keys (`keys` a block), the
    whole 64-column boxes and the narrow `tail` box past them (80: 16
    columns, 96: 32), whether a producer warpgroup issues the loads (else the
    first consumer thread), whether the warpgroups' dQ partials meet in
    shared memory before their reduce-add, and the column `parts` of dK/dV
    (two blocks a key block at 256, whose dQ comes from L1's dQ kernel)."""
    if d not in FLASH_HEAD_SIZES:
        raise ValueError(f"flash backward kernel takes head size {FLASH_HEAD_SIZES}, got {d}")
    dp = padded_head_size(d)
    tail = dp - 64 if dp in (80, 96) else 0
    warpgroups = 2 if dp <= 64 or tail else 1
    return dict(instance=dp, warpgroups=warpgroups, keys=64 * warpgroups,
                boxes=dp // 64 if tail else -(-dp // 64), tail=tail,
                producer_warpgroup=not tail, merged_dq=bool(tail),
                parts=2 if dp > 128 else 1)


def _pad_heads(x, dp: int):
    """x (.., D) as a new contiguous tensor of dp channels, zero past D."""
    return torch.nn.functional.pad(x, (0, dp - x.shape[-1]))


def _grouped(q, n_groups):
    b, hq, t, d = q.shape
    return q.reshape(b, n_groups, hq // n_groups, t, d)


def causal_attention_plain(q, k, v, scale: float | None = None):
    """The plain PyTorch version of K1's forward (`_causal_attention_xla` of
    the JAX package): fp32 logits and softmax, probabilities rounded to the
    query dtype before the PV product. Returns (B, Hq, T, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _softmax_times_v(_masked_logits(q, k, scale), q, v)


def _softmax_times_v(logits, q, v):
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v[:, :, None].to(q.dtype)).reshape(q.shape)


def _acc_dtype(dtype):
    """fp32 for bf16 and fp32 inputs, fp64 for fp64 (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _masked_logits(q, k, scale):
    """(B, G, q_per_kv, T, T) causal logits in the accumulation dtype."""
    b, hq, tq, d = q.shape
    g, tk = k.shape[1], k.shape[2]
    acc = _acc_dtype(q.dtype)
    logits = torch.matmul(_grouped(q, g).to(acc),
                          k.to(acc)[:, :, None].transpose(-1, -2)) * scale
    causal = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)
    return logits.masked_fill(~causal, float("-inf"))


def causal_attention_plain_lse(q, k, v, scale: float):
    """`causal_attention_plain` that also returns the row logsumexp L
    (B, Hq, T) in fp32, as K1's forward does: the plain forward that feeds
    `flash_attention_bwd_plain`."""
    logits = _masked_logits(q, k, scale)
    return _softmax_times_v(logits, q, v), torch.logsumexp(logits, dim=-1).reshape(q.shape[:3])


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """The plain PyTorch version of K1's backward: the explicit formula in
    fp32 (`_bwd_kernel` of the JAX package, without its blocking).

    Delta = rowsum(dO * O), P = exp(S * scale - L), dV = P^T dO,
    dS = P * (dO V^T - Delta), dQ = dS K * scale, dK = dS^T Q * scale; dK
    and dV are summed over the q_per_kv heads of each KV group. lse:
    (B, Hq, T). Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, hq, t, d = q.shape
    g = k.shape[1]
    acc = _acc_dtype(q.dtype)
    qg = _grouped(q, g).to(acc)
    dog = _grouped(do, g).to(acc)
    kf = k.to(acc)[:, :, None]
    vf = v.to(acc)[:, :, None]
    lse_g = lse.reshape(b, g, hq // g, t, 1).to(acc)
    delta = (dog * _grouped(o, g).to(acc)).sum(-1, keepdim=True)
    p = torch.exp(_masked_logits(q, k, scale) - lse_g)
    dv = torch.matmul(p.transpose(-1, -2), dog).sum(2)
    dp = torch.matmul(dog, vf.transpose(-1, -2))
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qg).sum(2) * scale
    return (dq.reshape(b, hq, t, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _aligned_rows(x) -> bool:
    return x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:3]) and not x.data_ptr() % 16


def _check_rows(name, x):
    if not _aligned_rows(x):
        raise ValueError(
            f"flash kernel needs 16-byte aligned rows of {name}: strides {x.stride()}")


def _flash_fwd(q, k, v, scale):
    """Launch K1's forward (a head size of `FLASH_HEAD_SIZES`). Returns (o
    (B, Hq, T, D) as a view of a (B, T, Hq, D') buffer, D' the padded head
    size, lse (B, Hq, T) fp32)."""
    device = _lib.check_cuda(q, k, v)
    b, hq, t, d = q.shape
    g = k.shape[1]
    if d not in FLASH_HEAD_SIZES:
        raise ValueError(f"flash kernel takes head size {FLASH_HEAD_SIZES}, got {d}")
    if k.shape != (b, g, t, d) or v.shape != (b, g, t, d) or hq % g:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bfloat16 {name}, got {x.dtype}")
    dp = padded_head_size(d)
    if dp != d:
        q, k, v = (_pad_heads(x, dp) for x in (q, k, v))
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, x)
    o = torch.empty((b, t, hq, dp), dtype=q.dtype, device=device).transpose(1, 2)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=device)
    if o.numel():
        FLASH_FWD(device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), b, hq, g, t, dp, float(scale),
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                  flops=4 * b * hq * t * t * d)  # Q K^T and P V, as FlopCounterMode counts SDPA
    return o[..., :d], lse


def flash_attention_bwd(q, k, v, o, lse, do, scale: float):
    """Launch K1's backward (a head size of `FLASH_HEAD_SIZES`). q, o, do: (B, Hq, T, D);
    k, v: (B, G, T, D), all bf16 with any (batch, head, token) strides and a
    unit channel stride (O as the forward's (B, T, Hq, D) view, dO as
    autograd hands it: neither is copied); lse: (B, Hq, T) fp32. Returns
    (dq, dk, dv)."""
    device = _lib.check_cuda(q, k, v, o, lse, do)
    b, hq, t, d = q.shape
    g = k.shape[1]
    if d not in FLASH_HEAD_SIZES:
        raise ValueError(f"flash backward kernel takes head size {FLASH_HEAD_SIZES}, "
                         f"got {d}")
    if (k.shape != (b, g, t, d) or v.shape != (b, g, t, d) or hq % g
            or o.shape != q.shape or do.shape != q.shape or lse.shape != (b, hq, t)):
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bfloat16 {name}, got {x.dtype}")
    if lse.dtype != torch.float32:
        raise TypeError(f"flash kernel takes fp32 lse, got {lse.dtype}")
    dp = padded_head_size(d)
    if dp != d:
        q, k, v, o, do = (_pad_heads(x, dp) for x in (q, k, v, o, do))
    if not _aligned_rows(do):
        do = do.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o)):
        _check_rows(name, x)
    lse = lse.contiguous()
    dq = torch.zeros((b, hq, t, dp), dtype=torch.float32, device=device)
    # L and Delta, each (B, Hq, T rounded up to 64): whole 64-row TMA boxes
    rows = torch.empty((2, b, hq, -(-t // 64) * 64), dtype=torch.float32, device=device)
    dk = torch.empty((b, g, t, dp), dtype=k.dtype, device=device)
    dv = torch.empty((b, g, t, dp), dtype=v.dtype, device=device)
    if q.numel():
        FLASH_BWD(device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), rows.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), b, hq, g, t, dp, float(scale),
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *o.stride()[:3], *do.stride()[:3], *dk.stride()[:3],
                  *dv.stride()[:3],
                  flops=10 * b * hq * t * t * d)  # S again, dP, dV, dQ, dK: SDPA's count
        BWD_HEAD_LAUNCHES[d] += 1
    return dq[..., :d].to(q.dtype), dk[..., :d], dv[..., :d]


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention with K1's forward and backward (the custom VJP of
    `flash_vjp.flash_attention`). On CPU tensors it runs the plain pair,
    `causal_attention_plain_lse` and `flash_attention_bwd_plain`."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            o, lse = causal_attention_plain_lse(q, k, v, scale)
        else:
            o, lse = _flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def causal_attention(q, k, v, scale: float | None = None):
    """q: (B, Hq, T, D); k, v: (B, G, T, D) with G = n_query_groups.
    `DUALHYP_ATTN_IMPL`, read at each call: "own" (the default) runs K1,
    with grad enabled and an input that needs it through the autograd op
    `FlashAttention`, else the forward alone; any other value runs L1
    (`ops/splash.causal_attention`), as the JAX function sends any value
    other than "own" to splash."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if os.environ.get("DUALHYP_ATTN_IMPL", "own") != "own":
        from dualhyp_tpu_torch.ops import splash

        return splash.causal_attention(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, scale)
    return _flash_fwd(q, k, v, scale)[0]


def decode_attention(q, k_cache, v_cache, kv_length, scale: float | None = None,
                     k_scale=None, v_scale=None):
    """One decode step against a fixed-size cache: `chunk_decode_attention`
    at K = 1, its query at slot kv_length - 1.

    q: (B, Hq, 1, D); k_cache, v_cache: (B, G, S, D); kv_length: (B,) valid
    cache slots per row (slots >= kv_length are masked); k_scale, v_scale:
    an int8 cache's (B, G, S) per-slot scales."""
    return chunk_decode_attention(q, k_cache, v_cache, kv_length - 1, scale,
                                  k_scale=k_scale, v_scale=v_scale)


def chunk_decode_attention(q, k_cache, v_cache, start, scale: float | None = None,
                           k_scale=None, v_scale=None):
    """A verify step's attention: K consecutive queries a row against the
    cache (`chunk_decode_attention` of the JAX package, plain PyTorch as
    the JAX package leaves it to XLA).

    q: (B, Hq, K, D), the tokens at slots start..start+K-1 of each row;
    k_cache, v_cache: (B, G, S, D), the K tokens' K/V already written;
    start: (B,). Query i sees the slots at or below start + i (its own
    included). The logits take exact fp32 products of the cached values,
    the softmax runs in fp32, and the probabilities are rounded to q's
    dtype before the PV product. k_scale, v_scale: the (B, G, S) per-slot
    scales of an int8 cache (`_dequant_cache` of the JAX package): the K
    scale multiplies the logits and the V scale the probabilities, slot by
    slot, so the int8 values enter the products as they are."""
    b, hq, kq, d = q.shape
    g, s = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = _grouped(q, g).float()  # (B, G, Qh, K, D)
    logits = torch.matmul(qg, k_cache.float()[:, :, None].transpose(-1, -2)) * scale
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, None, :].float()
    limit = start[:, None] + torch.arange(kq, device=q.device)[None, :]  # (B, K)
    valid = torch.arange(s, device=q.device)[None, None, :] <= limit[:, :, None]
    logits = logits.masked_fill(~valid[:, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[:, :, None, None, :].float()
    probs = probs.to(q.dtype)
    out = torch.matmul(probs, v_cache[:, :, None].to(q.dtype))
    return out.reshape(b, hq, kq, d)
