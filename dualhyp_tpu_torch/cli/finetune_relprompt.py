"""RelPrompt finetuning: the encoder-feature half.

Counterpart of the feature functions of `dualhyp_tpu/cli/finetune_relprompt.py`
(`feature_loader`, `_whisper_feature_loader`, `build_feature_batch`), which
RelPrompt inference (`cli.inference_relprompt`) reads its features through:

  * `--whisper_checkpoint`: frozen Whisper features computed on the card
    (`models.whisper.encode`, kernel K6 in every layer), the waveform loaded
    and its recorded corruption replayed on the host; visual features from
    `--feature_dir` when given, else zeros;
  * `--feature_dir`: `<uid>.npz` files with `audio` (T, 1280) and `visual`
    (T, 1024) arrays, as `cli.precompute_features` writes them;
  * `--synthetic_features`: seeded noise of the right lengths (pipeline
    checks only).

The training entry point (`main`, with `train/relprompt.py`) is not ported
yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from dualhyp_tpu_torch.data import masks as mask_lib
from dualhyp_tpu_torch.device import resolve_device


def feature_loader(args, cfg):
    """Returns fn(example, rng) -> (audio_feats, visual_feats) numpy."""
    if getattr(args, "whisper_checkpoint", None):
        return _whisper_feature_loader(args, cfg)
    if args.feature_dir:
        feature_dir = Path(args.feature_dir)

        def load(example, _rng):
            with np.load(feature_dir / f"{example.uid}.npz") as z:
                return z["audio"], z["visual"]

        return load
    if args.synthetic_features:
        def synth(example, rng):
            n_a = len(example.audio_bin_labels or [1])
            n_v = len(example.video_bin_labels or [1])
            audio = rng.standard_normal(
                (n_a * 2 * cfg.classifier_pool_size, cfg.whisper_dim)
            ).astype(np.float32)
            visual = rng.standard_normal(
                (n_v * cfg.classifier_pool_size, cfg.raven_dim)
            ).astype(np.float32)
            return audio, visual

        return synth
    raise SystemExit(
        "RelPrompt needs encoder features: pass --feature_dir (precomputed "
        "Whisper/BRAVEn features), --whisper_checkpoint (audio features on the "
        "card), or --synthetic_features (pipeline validation only)"
    )


def replayed_waveform(rec: dict) -> np.ndarray:
    """The record's clean waveform with its recorded audio corruption
    replayed (host side)."""
    from dualhyp_tpu_torch.data import corruption

    audio = corruption.load_wav(rec["Clean_Wav"])
    if rec.get("Audio_Corruption") and rec.get("Noise_Wav"):
        noise = corruption.load_wav(rec["Noise_Wav"])
        audio = corruption.add_audio_noise(audio, noise, rec["Audio_Corruption"])
    return audio


def whisper_audio_features(encoder, audio: np.ndarray) -> np.ndarray:
    """One utterance's frozen Whisper features (T, n_state) as numpy: the
    log-mel spectrogram on the host, then `encode` (fp32) on the encoder's
    device. encoder: (params, cfg)."""
    from dualhyp_tpu_torch.models import whisper as w

    params, cfg = encoder
    mel = w.log_mel_spectrogram(audio, cfg.n_mels)
    device = params["ln_post"]["scale"].device
    feats = w.encode(params, cfg, torch.from_numpy(mel[None]).to(device))
    return feats[0].cpu().numpy()


def _whisper_feature_loader(args, cfg):
    """Frozen Whisper features computed on the card: the encoder is loaded
    once onto `--device` (the card by default) and encodes each utterance
    there; waveform loading and corruption replay happen on the host.
    Visual features come from --feature_dir when present, else zeros."""
    from dualhyp_tpu_torch.cli.make_json_asr import load_whisper

    device = resolve_device(getattr(args, "device", None))
    encoder, _, _ = load_whisper(args.whisper_checkpoint, device=device)
    feature_dir = Path(args.feature_dir) if args.feature_dir else None

    def load(example, _rng):
        rec = example.records[0]
        audio_feats = whisper_audio_features(encoder, replayed_waveform(rec))
        if feature_dir is not None:
            with np.load(feature_dir / f"{example.uid}.npz") as z:
                visual = z["visual"]
        else:
            n_v = len(example.video_bin_labels or [1])
            visual = np.zeros((n_v * cfg.classifier_pool_size, cfg.raven_dim), np.float32)
        return audio_feats, visual

    return load


def build_feature_batch(examples, loader, rng, cfg):
    """Features and mask targets of a batch, zero-padded to its longest."""
    feats = [loader(ex, rng) for ex in examples]

    def pad_stack(arrs):
        t = max(a.shape[0] for a in arrs)
        out = np.zeros((len(arrs), t, arrs[0].shape[1]), np.float32)
        for i, a in enumerate(arrs):
            out[i, : a.shape[0]] = a
        return out

    def pad_targets(rows):
        t = max(len(r) for r in rows)
        out = np.zeros((len(rows), t), np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    return {
        "audio_features": pad_stack([f[0] for f in feats]),
        "visual_features": pad_stack([f[1] for f in feats]),
        "audio_mask_targets": pad_targets(
            [mask_lib.bins_to_indices(ex.audio_bin_labels) for ex in examples]
        ),
        "visual_mask_targets": pad_targets(
            [mask_lib.bins_to_indices(ex.video_bin_labels) for ex in examples]
        ),
    }
