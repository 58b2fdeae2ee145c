"""ESPnet transformer decoder and CTC head (joint CTC/attention decoding).

Counterpart of `dualhyp_tpu/models/espnet_decoder.py` (ref: data/raven/
espnet/nets/pytorch_backend/transformer/decoder.py, decoder_layer.py):
token embedding + scaled absolute sinusoidal positions, pre-LN blocks of
(causal self-attention, source attention over the encoder memory,
position-wise FF), after_norm and the vocabulary projection. Inference only.

  * `decode_logits`: the full forward over a token prefix (the per-utterance
    beam's scorer and the reference the cached step is tested against);
  * `ctc_log_probs`: the CTC head;
  * `precompute_cross_kv`, `init_self_cache`, `decode_step_cached`: the
    cached one-token step of the device beam (`infer/joint_device_beam`),
    the self cache (R, L, H, T, dk) with rows leading, the source attention
    grouped over the beam rows of an utterance.

The cached step's products take their operands in their dtype with an fp32
result (`models/whisper.f32_product`), as the JAX package's
`preferred_element_type=float32` products do; the scores and softmax are
fp32. A beam re-parents the cache by index (`reparent`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from dualhyp_tpu_torch.device import to_device
from dualhyp_tpu_torch.models.raven import Draw, _linear, _ln, _nest, abs_positions
from dualhyp_tpu_torch.models.whisper import f32_product


@dataclass(frozen=True)
class EspnetDecoderConfig:
    odim: int = 1049                # unigram1000 + specials (raven labels)
    attention_dim: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6


def _mha(leaf: dict, q_in, kv_in, n_head: int, causal=False, kv_length=None):
    b, tq, d = q_in.shape
    tk = kv_in.shape[1]
    dk = d // n_head

    def split(leafk, x, t):
        return _linear(leafk, x).view(b, t, n_head, dk).transpose(1, 2)

    q = split(leaf["linear_q"], q_in, tq)
    k = split(leaf["linear_k"], kv_in, tk)
    v = split(leaf["linear_v"], kv_in, tk)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dk)
    if causal:
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        scores = scores.masked_fill(~keep[None, None], float("-inf"))
    if kv_length is not None:
        # padded memory frames are masked out
        valid = torch.arange(tk, device=q.device)[None, :] < kv_length[:, None]
        scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q_in.dtype)
    dt = torch.promote_types(w.dtype, v.dtype)  # a mixed-dtype einsum promotes
    out = torch.matmul(w.to(dt), v.to(dt)).transpose(1, 2).reshape(b, tq, d)
    return _linear(leaf["linear_out"], out)


def decode_logits(params: dict, cfg: EspnetDecoderConfig, tokens, memory,
                  memory_length=None):
    """tokens (B, T) int; memory (B, S, adim) -> (B, T, odim) logits
    (pre-softmax). memory_length (B,): valid frames of a right-padded
    memory. The fp32 positions promote a bf16 embedding to fp32 here, as
    they do in the JAX package."""
    d = cfg.attention_dim
    x = params["embed"]["weight"][tokens]
    x = x * math.sqrt(d) + to_device(abs_positions(tokens.shape[1], d), x.device)
    for i in range(cfg.num_blocks):
        leaf = params["layers"][str(i)]
        n = _ln(leaf["norm1"], x)
        x = x + _mha(leaf["self_attn"], n, n, cfg.attention_heads, causal=True)
        x = x + _mha(leaf["src_attn"], _ln(leaf["norm2"], x), memory, cfg.attention_heads,
                     kv_length=memory_length)
        n = _ln(leaf["norm3"], x)
        x = x + _linear(leaf["feed_forward"]["w_2"],
                        torch.relu(_linear(leaf["feed_forward"]["w_1"], n)))
    x = _ln(params["after_norm"], x)
    return _linear(params["output_layer"], x)


def ctc_log_probs(params: dict, memory):
    """CTC head over encoder memory: (B, S, adim) -> (B, S, odim) log-probs
    (ref: espnet/nets/pytorch_backend/ctc.py log_softmax)."""
    return torch.log_softmax(_linear(params["ctc_lo"], memory), dim=-1)


# ---------------------------------------------------------------------------
# the cached one-token step
# ---------------------------------------------------------------------------

def precompute_cross_kv(params: dict, cfg: EspnetDecoderConfig, memory) -> dict:
    """Source-attention K/V of every layer from the encoder memory, once an
    utterance: memory (U, S, adim) -> {"k", "v"} of (L, U, H, S, dk) in
    memory's dtype."""
    u, s, _ = memory.shape
    h = cfg.attention_heads
    dk = cfg.attention_dim // h
    ks, vs = [], []
    for i in range(cfg.num_blocks):
        leaf = params["layers"][str(i)]["src_attn"]
        ks.append(_linear(leaf["linear_k"], memory).view(u, s, h, dk).transpose(1, 2))
        vs.append(_linear(leaf["linear_v"], memory).view(u, s, h, dk).transpose(1, 2))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def init_self_cache(cfg: EspnetDecoderConfig, batch: int, max_len: int,
                    dtype=torch.float32, device=None) -> dict:
    """Self-attention cache, rows leading: {"k", "v"} of (R, L, H, max_len,
    dk), so a row's whole history is one contiguous block."""
    h = cfg.attention_heads
    shape = (batch, cfg.num_blocks, h, max_len, cfg.attention_dim // h)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def reparent(cache: dict, parents, n_cols: int) -> None:
    """Columns 0..n_cols-1 of row i become those of row parents[i], in
    place, in every layer: a beam's histories re-parented by index."""
    if n_cols <= 0:
        return
    for t in cache.values():
        hist = t[..., :n_cols, :]
        hist.copy_(hist.index_select(0, parents))


def decode_step_cached(params: dict, cfg: EspnetDecoderConfig, tokens, pos: int,
                       cache: dict, cross_kv: dict, memory_length, pos_table,
                       n_per_group: int = 1):
    """One decoder step for (R,) tokens at position `pos` (an int: the rows
    advance in lockstep). Returns (logits (R, V), cache); the cache is
    written in place at column `pos` and attended at columns 0..pos.

    cross_kv: `precompute_cross_kv` of U utterances, R = U * n_per_group
    rows grouped by utterance (beam rows share a memory); memory_length:
    (U,) valid frames; pos_table: (T_max, adim) absolute positions."""
    r = tokens.shape[0]
    d = cfg.attention_dim
    h = cfg.attention_heads
    dk = d // h
    u = r // n_per_group
    s = cross_kv["k"].shape[3]
    x = params["embed"]["weight"][tokens]
    x = (x * math.sqrt(d) + pos_table[pos].to(x.dtype))[:, None, :]  # (R, 1, D)
    dtype = x.dtype
    scale = 1.0 / math.sqrt(dk)
    s_keep = (torch.arange(s, device=x.device)[None, :] < memory_length[:, None])[:, None, None, :]
    cache_k, cache_v = cache["k"], cache["v"]
    for i in range(cfg.num_blocks):
        leaf = params["layers"][str(i)]
        # self attention: this token's K/V written at pos, columns <= pos read
        n1 = _ln(leaf["norm1"], x)
        sa = leaf["self_attn"]
        q = _linear(sa["linear_q"], n1).view(r, h, 1, dk)
        cache_k[:, i, :, pos] = _linear(sa["linear_k"], n1).view(r, h, dk).to(cache_k.dtype)
        cache_v[:, i, :, pos] = _linear(sa["linear_v"], n1).view(r, h, dk).to(cache_v.dtype)
        ck = cache_k[:, i, :, : pos + 1]
        cv = cache_v[:, i, :, : pos + 1]
        scores = f32_product(q, ck.transpose(-1, -2)) * scale
        w = torch.softmax(scores, dim=-1).to(dtype)
        sa_out = torch.matmul(w, cv.to(dtype)).reshape(r, 1, d)
        x = x + _linear(sa["linear_out"], sa_out)

        # source attention, grouped: an utterance's rows share its memory
        src = leaf["src_attn"]
        q2 = _linear(src["linear_q"], _ln(leaf["norm2"], x))
        q2 = q2.view(u, n_per_group, h, dk).transpose(1, 2)  # (U, H, G, dk)
        s_scores = f32_product(q2, cross_kv["k"][i].transpose(-1, -2)) * scale
        s_scores = s_scores.masked_fill(~s_keep, float("-inf"))
        sw = torch.softmax(s_scores, dim=-1).to(dtype)
        src_out = torch.matmul(sw, cross_kv["v"][i].to(dtype))  # (U, H, G, dk)
        x = x + _linear(src["linear_out"], src_out.transpose(1, 2).reshape(r, 1, d))

        n3 = _ln(leaf["norm3"], x)
        x = x + _linear(leaf["feed_forward"]["w_2"],
                        torch.relu(_linear(leaf["feed_forward"]["w_1"], n3)))
    x = _ln(params["after_norm"], x)
    return _linear(params["output_layer"], x)[:, 0], cache


# ---------------------------------------------------------------------------
# conversion and random trees
# ---------------------------------------------------------------------------

def convert_espnet_decoder(state: dict, cfg: EspnetDecoderConfig, prefix: str = "") -> dict:
    tree = _nest(state, prefix)
    return {"embed": tree["embed"]["0"],
            "layers": {str(i): tree["decoders"][str(i)] for i in range(cfg.num_blocks)},
            "after_norm": tree["after_norm"], "output_layer": tree["output_layer"]}


def init_decoder(cfg: EspnetDecoderConfig, generator: torch.Generator, *, device=None,
                 dtype=torch.float32) -> dict:
    """A random decoder tree at any config."""
    r = Draw(generator, device, dtype)
    d, lu = cfg.attention_dim, cfg.linear_units

    def attn():
        return {name: r.lin(d, d) for name in ("linear_q", "linear_k", "linear_v", "linear_out")}

    layers = {str(i): {"norm1": r.ln(d), "norm2": r.ln(d), "norm3": r.ln(d),
                       "self_attn": attn(), "src_attn": attn(),
                       "feed_forward": {"w_1": r.lin(lu, d), "w_2": r.lin(d, lu)}}
              for i in range(cfg.num_blocks)}
    return {"embed": {"weight": r.normal(cfg.odim, d)}, "layers": layers,
            "after_norm": r.ln(d), "output_layer": r.lin(cfg.odim, d)}


def init_ctc(odim: int, adim: int, generator: torch.Generator, *, device=None,
             dtype=torch.float32) -> dict:
    """A random CTC head: {"ctc_lo": Linear(adim -> odim)}."""
    return {"ctc_lo": Draw(generator, device, dtype).lin(odim, adim)}


def position_table(cfg: EspnetDecoderConfig, t_max: int, device="cpu") -> torch.Tensor:
    """The (t_max, adim) fp32 positions `decode_step_cached` reads."""
    return to_device(abs_positions(t_max, cfg.attention_dim), device)
