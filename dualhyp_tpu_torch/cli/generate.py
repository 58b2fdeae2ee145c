"""Standalone text generation from a checkpoint (== generate/base.py main).

Counterpart of `dualhyp_tpu/cli/generate.py`:

  python -m dualhyp_tpu_torch.cli.generate --prompt "Hello, my name is" \\
      --llm_checkpoint checkpoints/TinyLlama/TinyLlama-1.1B-Chat-v1.0 \\
      --max_new_tokens 50 --temperature 0.8 --top_k 200

LoRA checkpoints load over the base weights via --model_path (leaves the
checkpoint lacks keep their values); --merge_lora folds the LoRA deltas
into the weights and --quantize int8 quantizes them. Sampling draws from a
torch generator seeded with --seed, so only greedy output (--top_k 1) is
comparable with the JAX package's. Runs on the card unless --device names
another.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from dualhyp_tpu_torch.cli import common
from dualhyp_tpu_torch.device import resolve_device
from dualhyp_tpu_torch.infer.decode import generate
from dualhyp_tpu_torch.models.gpt import merge_lora, quantize_model


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--prompt", type=str, default="Hello, my name is")
    parser.add_argument("--num_samples", type=int, default=1)
    parser.add_argument("--max_new_tokens", type=int, default=50)
    parser.add_argument("--top_k", type=int, default=200)
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--merge_lora", action="store_true")
    parser.add_argument("--quantize", choices=[None, "int8"], default=None)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; raises "
                             "without one)")
    common.add_model_args(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    checkpoint_dir = Path(args.llm_checkpoint)
    tokenizer = common.load_tokenizer(checkpoint_dir)
    cfg = common.model_config_from_args(args)
    model = common.load_model(checkpoint_dir, cfg, device=device, seed=args.seed,
                              finetuned=args.model_path)
    if args.merge_lora and cfg.any_lora:
        merge_lora(model)
    if args.quantize == "int8":
        quantize_model(model, "int8")

    ids = torch.from_numpy(np.asarray(tokenizer.encode(args.prompt), np.int64)[None])
    lengths = torch.tensor([ids.shape[1]])
    generator = torch.Generator(device=model.device)
    generator.manual_seed(args.seed)
    outputs = []
    for i in range(args.num_samples):
        t0 = time.perf_counter()
        tokens, total = generate(
            model, ids, lengths, max_new_tokens=args.max_new_tokens,
            temperature=args.temperature, top_k=args.top_k,
            eos_id=getattr(tokenizer, "eos_token_id", None), generator=generator)
        tokens = tokens.cpu().numpy()
        n_total = int(total[0])
        dt = time.perf_counter() - t0
        n_new = n_total - ids.shape[1]
        text = tokenizer.decode(tokens[0][:n_total])
        outputs.append(text)
        print(text)
        print(f"# sample {i}: {n_new} tokens in {dt:.2f}s "
              f"({n_new / max(dt, 1e-9):.1f} tok/s)")
    return outputs


if __name__ == "__main__":
    main()
