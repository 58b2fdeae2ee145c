"""ESPnet TransformerLM (the shallow-fusion scorer of joint decoding).

Counterpart of `dualhyp_tpu/models/espnet_lm.py` (ref: data/raven/espnet/
nets/pytorch_backend/lm/transformer.py:80-170): token embedding -> encoder
with the linear input layer (Linear -> LayerNorm -> ReLU -> scaled
sinusoidal positions) and causal self-attention -> the vocabulary head.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dualhyp_tpu_torch.models import raven
from dualhyp_tpu_torch.models.raven import Draw, _linear


@dataclass(frozen=True)
class EspnetLMConfig:
    n_vocab: int = 1049
    embed_unit: int = 128
    att_unit: int = 256
    head: int = 2
    unit: int = 1024
    layer: int = 4


def encoder_config(cfg: EspnetLMConfig) -> raven.RavenEncoderConfig:
    return raven.RavenEncoderConfig(idim=cfg.embed_unit, attention_dim=cfg.att_unit,
                                    attention_heads=cfg.head, linear_units=cfg.unit,
                                    num_blocks=cfg.layer, attn_layer_type="mha")


def lm_hidden(params: dict, cfg: EspnetLMConfig, tokens):
    """tokens (B, T) -> (B, T, att_unit) causal encoder states. The causal
    mask is 3-D (1, T, T), so `raven.encode` cannot read it as a (B, S)
    padding mask when the batch size equals T."""
    emb = params["embed"]["weight"][tokens]
    t = tokens.shape[1]
    causal = torch.ones(t, t, dtype=torch.bool, device=emb.device).tril()[None]
    return raven.encode(params["encoder"], encoder_config(cfg), emb, mask=causal)


def lm_logprobs(params: dict, cfg: EspnetLMConfig, tokens):
    """tokens (B, T) -> (B, V) next-token log-probs at the last position."""
    logits = _linear(params["decoder"], lm_hidden(params, cfg, tokens)[:, -1])
    return torch.log_softmax(logits, dim=-1)


def lm_logprobs_at(params: dict, cfg: EspnetLMConfig, tokens, pos: int):
    """Next-token log-probs read at position `pos` of a right-padded token
    buffer (the causal mask keeps the padding out of position pos)."""
    logits = _linear(params["decoder"], lm_hidden(params, cfg, tokens)[:, pos])
    return torch.log_softmax(logits, dim=-1)


def convert_espnet_lm(state: dict, cfg: EspnetLMConfig) -> dict:
    enc = raven.convert_espnet_encoder(state, encoder_config(cfg), prefix="encoder.")
    tree = raven._nest(state, "")
    return {"embed": {"weight": tree["embed"]["weight"]}, "encoder": enc,
            "decoder": {"weight": tree["decoder"]["weight"], "bias": tree["decoder"]["bias"]}}


def init_lm(cfg: EspnetLMConfig, generator: torch.Generator, *, device=None,
            dtype=torch.float32) -> dict:
    """A random LM tree at any config."""
    enc = raven.init_encoder(encoder_config(cfg), generator, device=device, dtype=dtype)
    r = Draw(generator, device, dtype)
    return {"embed": {"weight": r.normal(cfg.n_vocab, cfg.embed_unit)}, "encoder": enc,
            "decoder": r.lin(cfg.n_vocab, cfg.att_unit)}
