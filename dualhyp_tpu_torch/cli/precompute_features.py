"""Precompute frozen-encoder features for RelPrompt.

Counterpart of `dualhyp_tpu/cli/precompute_features.py`, audio features:
the frozen features never change, so they are computed once per corruption
variant and read back with `--feature_dir`:

  python -m dualhyp_tpu_torch.cli.precompute_features \\
      --json corpus.json --out_dir features/ \\
      --whisper_checkpoint checkpoints/openai/whisper-large-v3

Writes <uid>.npz with:
  audio  (T_a, whisper_dim)  log-mel -> Whisper encoder on the card (kernel
                             K6 in every layer), corruption replayed
  visual (T_v, raven_dim)    zeros of the record's `total_len` frames (the
                             BRAVEn encoder, `--raven_checkpoint`, is not
                             ported yet)

A record whose waveforms cannot be read is skipped with a message, as the
JAX package skips it; a fault of the encoder on the card stops the run.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", required=True, help="hypotheses JSON")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--whisper_checkpoint", required=True)
    parser.add_argument("--raven_checkpoint", default=None, help="not ported yet")
    parser.add_argument("--raven_dim", type=int, default=1024,
                        help="width of the (zero) visual features")
    parser.add_argument("--shard_index", type=int, default=0)
    parser.add_argument("--num_shards", type=int, default=1)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; raises "
                             "without one)")
    args = parser.parse_args(argv)
    if args.raven_checkpoint:
        raise NotImplementedError(
            "--raven_checkpoint: the BRAVEn visual encoder is not ported yet (slice 7)")

    from dualhyp_tpu_torch.cli.finetune_relprompt import (replayed_waveform,
                                                           whisper_audio_features)
    from dualhyp_tpu_torch.cli.make_json_asr import load_whisper
    from dualhyp_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
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
        except (OSError, ValueError) as exc:
            print(f"skip {uid}: {type(exc).__name__}: {exc}")
            continue
        audio_feats = whisper_audio_features(encoder, audio)
        n_frames = (rec.get("Visual_Corruption") or {}).get("total_len", 25)
        visual_feats = np.zeros((n_frames, args.raven_dim), np.float32)
        np.savez(out_path, audio=audio_feats, visual=visual_feats)
        done += 1
    print(f"wrote {done} feature files to {out_dir}")
    return done


if __name__ == "__main__":
    main()
