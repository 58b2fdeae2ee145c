"""Precompute frozen-encoder features for RelPrompt.

Counterpart of `dualhyp_tpu/cli/precompute_features.py`: the frozen
features never change, so they are computed once per corruption variant and
read back with `--feature_dir`:

  python -m dualhyp_tpu_torch.cli.precompute_features \\
      --json corpus.json --out_dir features/ \\
      --whisper_checkpoint checkpoints/openai/whisper-large-v3 \\
      [--raven_checkpoint braven.npz [--raven_config '{...}'] [--occ_type pixelate]]

Writes <uid>.npz with:
  audio  (T_a, whisper_dim)  log-mel -> Whisper encoder on the card (kernel
                             K6 in every layer), corruption replayed
  visual (T_v, raven_dim)    the mouth ROI, its recorded occlusion replayed
                             -> Conv3D + BRAVEn encoder on the card
                             (`--raven_checkpoint`: an npz with `frontend`
                             and `encoder` trees, BRAVEn-large unless
                             `--raven_config` overrides fields); zeros of
                             the record's `total_len` frames without one

A record whose waveform or mouth ROI cannot be read is skipped with a
message, as the JAX package skips it; a fault of an encoder on the card
stops the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from dualhyp_tpu_torch.ckpt.convert import raven_from_jax
from dualhyp_tpu_torch.ckpt.io import load_params
from dualhyp_tpu_torch.cli.finetune_relprompt import replayed_waveform, whisper_audio_features
from dualhyp_tpu_torch.cli.make_json_asr import load_whisper
from dualhyp_tpu_torch.cli.make_json_vsr import encode_batch, load_mouthroi
from dualhyp_tpu_torch.data import corruption
from dualhyp_tpu_torch.device import resolve_device
from dualhyp_tpu_torch.models import raven


def replayed_video(rec: dict, occ_type=None) -> np.ndarray:
    """A record's mouth ROI with its recorded occlusion replayed, through
    the eval transforms: (T, 88, 88) fp32. The occlusion type is
    `occ_type`, else the record's Noise_Category[1] when that is a pair,
    else pixelate (the JAX package's rule)."""
    video = load_mouthroi(rec["Mouthroi"])
    if rec.get("Visual_Corruption"):
        category = rec.get("Noise_Category")
        occ = occ_type or (category[1] if isinstance(category, (list, tuple)) else "pixelate")
        video, _ = corruption.occlude_sequence(video, occ,
                                               occlude_config=rec["Visual_Corruption"])
    return corruption.eval_pipeline(video.astype(np.float32))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", required=True, help="hypotheses JSON")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--whisper_checkpoint", required=True)
    parser.add_argument("--raven_checkpoint", default=None,
                        help="npz with frontend/encoder trees (see models/raven)")
    parser.add_argument("--raven_dim", type=int, default=1024,
                        help="width of the zero visual features without --raven_checkpoint")
    parser.add_argument("--raven_config", default=None,
                        help="JSON dict of RavenEncoderConfig field overrides (default: "
                             "BRAVEn-large)")
    parser.add_argument("--occ_type", default=None,
                        help="override Noise_Category for the occlusion replay")
    parser.add_argument("--shard_index", type=int, default=0)
    parser.add_argument("--num_shards", type=int, default=1)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; raises "
                             "without one)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    visual = None
    if args.raven_checkpoint:
        weights = load_params(args.raven_checkpoint)
        r_cfg = dataclasses.replace(raven.BRAVEN_LARGE, **json.loads(args.raven_config or "{}"))
        visual = (raven_from_jax(weights["frontend"], device=device),
                  raven_from_jax(weights["encoder"], device=device), r_cfg)
    encoder, _, _ = load_whisper(args.whisper_checkpoint, device=device)

    with open(args.json, encoding="utf-8") as fp:
        records = json.load(fp)
    records = records[args.shard_index :: args.num_shards]

    done = 0
    for rec in records:
        uid = rec["Uid"]
        out_path = out_dir / f"{uid}.npz"
        if out_path.is_file():
            continue
        try:
            audio = replayed_waveform(rec)
            video = (replayed_video(rec, args.occ_type)
                     if visual is not None and rec.get("Mouthroi") else None)
        except (OSError, ValueError) as exc:
            print(f"skip {uid}: {type(exc).__name__}: {exc}")
            continue
        audio_feats = whisper_audio_features(encoder, audio)
        if video is not None:
            visual_feats = encode_batch(*visual, [video])[0]
        else:
            n_frames = (rec.get("Visual_Corruption") or {}).get("total_len", 25)
            visual_feats = np.zeros((n_frames, args.raven_dim), np.float32)
        np.savez(out_path, audio=audio_feats, visual=visual_feats)
        done += 1
    print(f"wrote {done} feature files to {out_dir}")
    return done


if __name__ == "__main__":
    main()
