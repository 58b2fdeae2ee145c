"""Offline ASR n-best generation: the Whisper checkpoint loader only.

Counterpart of `load_whisper` in `dualhyp_tpu/cli/make_json_asr.py`, encoder
half: the RelPrompt feature loaders (`cli.finetune_relprompt`,
`cli.precompute_features`) read the frozen encoder through it. The decoder,
the tokenizer and the beam-search generator are not ported yet (slice 6).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from dualhyp_tpu_torch.ckpt.convert import encoder_from_jax
from dualhyp_tpu_torch.ckpt.io import load_safetensors
from dualhyp_tpu_torch.device import resolve_device
from dualhyp_tpu_torch.models import whisper as w


def load_whisper(checkpoint_dir, need_tokenizer=False, need_decoder=False, *,
                 device=None, dtype=torch.float32):
    """HF whisper directory (`config.json` + `*.safetensors`) -> ((encoder
    params, encoder config), None, None), the JAX package's return shape
    with the decoder's and the tokenizer's slots empty. The weights are read
    by `ckpt.io.load_safetensors` (F32, F16 or BF16 on disk) and put on
    `device` (the card when None) in `dtype`: fp32, the encoder's compute
    dtype, holds fp16 and bf16 weights exactly. The config, `n_mels`
    included, comes from `config.json`."""
    if need_tokenizer or need_decoder:
        raise NotImplementedError(
            "the Whisper decoder and tokenizer are not ported yet (slice 6)")
    device = resolve_device(device)
    checkpoint_dir = Path(checkpoint_dir)
    tensors = {}
    for shard in sorted(checkpoint_dir.glob("*.safetensors")):
        tensors.update(load_safetensors(shard))
    if not tensors:
        raise FileNotFoundError(f"no *.safetensors under {checkpoint_dir}")
    with open(checkpoint_dir / "config.json", encoding="utf-8") as fp:
        hf_cfg = json.load(fp)
    enc_cfg = w.WhisperEncoderConfig(
        n_mels=hf_cfg["num_mel_bins"],
        n_ctx=hf_cfg["max_source_positions"],
        n_state=hf_cfg["d_model"],
        n_head=hf_cfg["encoder_attention_heads"],
        n_layer=hf_cfg["encoder_layers"],
    )
    enc = encoder_from_jax(w.convert_hf_whisper_encoder(tensors, enc_cfg), device=device,
                           dtype=dtype)
    return (enc, enc_cfg), None, None
