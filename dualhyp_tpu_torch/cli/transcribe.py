"""Long-form transcription CLI (the reference ships `whisper.transcribe`'s
cli — ref: data/whisper/transcribe.py:459-559): the counterpart of
`dualhyp_tpu/cli/transcribe.py` over `infer/transcribe.py`, on the card
unless `--device cpu` is given.

    python -m dualhyp_tpu_torch.cli.transcribe audio1.wav audio2.wav \\
        --whisper_checkpoint checkpoints/whisper-large-v3 \\
        --beam_size 5 --language en --output_dir out/

Per audio file, writes <stem>.json with the n-best long-form transcripts
({"text", "segments", "language"} per hypothesis rank — the fork's
distinctive per-hypothesis seek output) and prints the best text.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("audio", nargs="+", help="wav file(s), 16 kHz mono")
    parser.add_argument("--whisper_checkpoint", required=True,
                        help="HF whisper dir (safetensors + config.json)")
    parser.add_argument("--output_dir", "-o", default=".")
    parser.add_argument("--language", default=None,
                        help="spoken language code; omit to detect from "
                             "the first 30 seconds")
    parser.add_argument("--beam_size", type=int, default=5)
    parser.add_argument("--patience", type=float, default=None)
    parser.add_argument("--length_penalty", type=float, default=None)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--temperature_increment_on_fallback", type=float,
                        default=0.2)
    parser.add_argument("--compression_ratio_threshold", type=float,
                        default=2.4)
    parser.add_argument("--logprob_threshold", type=float, default=-1.0)
    parser.add_argument("--no_speech_threshold", type=float, default=0.6)
    parser.add_argument("--initial_prompt", default=None)
    parser.add_argument(
        "--condition_on_previous_text",
        type=lambda s: s.lower() not in ("false", "0", "no"),
        default=True,
        help="roll each window's decoded tokens into the next window's "
             "prompt per hypothesis stream (ref: data/whisper/"
             "transcribe.py:48,490)",
    )
    parser.add_argument("--word_timestamps", action="store_true")
    parser.add_argument("--max_new_tokens", type=int, default=224)
    parser.add_argument("--cross_kv_quant", default=None, choices=("int8",),
                        help="int8 cross-attention K/V for the window "
                             "beams (opt-in: outputs may shift within "
                             "quantization rounding)")
    parser.add_argument("--self_kv_quant", default=None, choices=("int8",),
                        help="int8 self-attention KV cache (same opt-in "
                             "caveat)")
    parser.add_argument("--quantize", default=None, choices=("int8", "int4"),
                        help="int8/int4 decoder WEIGHTS (ref: ger/utils.py:"
                             "40-92 applied to this pipeline; int4 runs "
                             "kernel K8). Opt-in: outputs may shift within "
                             "rounding")
    parser.add_argument("--device", default=None,
                        help="where to run: the card when omitted; 'cpu' runs "
                             "the plain PyTorch versions of the kernels")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from dualhyp_tpu_torch.cli import make_json_asr
    from dualhyp_tpu_torch.data.corruption import load_wav
    from dualhyp_tpu_torch.infer.transcribe import transcribe

    encoder, decoder, tokenizer = make_json_asr.load_whisper(
        args.whisper_checkpoint, need_tokenizer=True, need_decoder=True,
        device=args.device, dtype=None)
    if args.quantize:
        from dualhyp_tpu_torch.ops import quant

        decoder = (quant.quantize_tree(decoder[0], args.quantize),
                   decoder[1])
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.temperature_increment_on_fallback is not None:
        temperature = tuple(
            np.arange(args.temperature, 1.0 + 1e-6,
                      args.temperature_increment_on_fallback).tolist()
        )
    else:
        temperature = args.temperature

    for path in args.audio:
        audio = load_wav(path)
        results = transcribe(
            audio, encoder, decoder, tokenizer,
            language=args.language, beam_size=args.beam_size,
            temperature=temperature,
            compression_ratio_threshold=args.compression_ratio_threshold,
            logprob_threshold=args.logprob_threshold,
            no_speech_threshold=args.no_speech_threshold,
            condition_on_previous_text=args.condition_on_previous_text,
            initial_prompt=args.initial_prompt,
            max_new_tokens=args.max_new_tokens,
            patience=args.patience, length_penalty=args.length_penalty,
            word_timestamps=args.word_timestamps,
            cross_kv_quant=args.cross_kv_quant,
            self_kv_quant=args.self_kv_quant,
        )
        out_path = out_dir / (Path(path).stem + ".json")
        with open(out_path, "w", encoding="utf-8") as fp:
            json.dump(results, fp, indent=2, ensure_ascii=False)
        print(f"{path}: {results[0]['text']}")
        print(f"  ({len(results)} hypotheses -> {out_path})")


if __name__ == "__main__":
    main()
