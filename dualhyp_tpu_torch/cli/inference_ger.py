"""GER / DualHyp correction + WER evaluation entry point.

Counterpart of `dualhyp_tpu/cli/inference_ger.py`, lockstep greedy path:

  python -m dualhyp_tpu_torch.cli.inference_ger \\
      --test_path test.json --model_path runs/exp/best_model.npz \\
      --llm_checkpoint checkpoints/TinyLlama/TinyLlama-1.1B-Chat-v1.0 \\
      --dual_hypotheses --prompts_format DualHyp

Protocol parity with the reference (ref: inference/ger.py:71-117):
temperature 0.2, top_k 1 (greedy), max_new 150, EOS stop, prompt-prefix
strip + first line; metrics WER, exact matches, post-normalised WER;
predictions JSON written next to the checkpoint. Decoding is batched
(--decode_batch, default 8). Runs on the card unless --device names another.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from dualhyp_tpu_torch.cli import common
from dualhyp_tpu_torch.data.collate import bucket_length
from dualhyp_tpu_torch.device import resolve_device
from dualhyp_tpu_torch.infer.decode import generate
from dualhyp_tpu_torch.infer.evaluate import evaluate_predictions, extract_response

NOT_PORTED = ("quantize", "kv_quant", "speculative")


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--test_path", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--seed", type=int, default=1337,
                        help="seed of the random init of weights the "
                             "checkpoint lacks")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; raises "
                             "without one)")
    parser.add_argument("--decode_batch", type=int, default=8)
    parser.add_argument("--max_new_tokens", type=int, default=150)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top_k", type=int, default=1)
    parser.add_argument("--quantize", choices=[None, "int8", "int4"], default=None,
                        help="not ported yet")
    parser.add_argument("--kv_quant", choices=[None, "int8"], default=None,
                        help="not ported yet")
    parser.add_argument("--speculative", nargs="?", const="lookup",
                        choices=["lookup", "anchored"], default=None,
                        help="not ported yet")
    parser.add_argument("--scheduler", choices=["lockstep", "continuous"],
                        default="lockstep",
                        help="only lockstep is ported yet")
    common.add_model_args(parser)
    common.add_data_args(parser)
    return parser


def run_inference(model, tokenizer, dataset, *, decode_batch=8,
                  max_new_tokens=150, temperature=0.2, top_k=1,
                  collect_latency=False, generator=None):
    """Batched correction over a dataset. Returns (records, metrics).

    Prompts are sorted by length and decoded `decode_batch` at a time,
    right-padded to the next length bucket; a short last batch repeats its
    last prompt and drops the repeats. Latency is per batch, shared by its
    prompts. collect_latency adds p50/p90 latency, the generated tokens (EOS
    not counted, repeats dropped) and their rate over the decode time."""
    cfg = model.cfg
    eos_id = getattr(tokenizer, "eos_token_id", None)
    examples = [dataset[i] for i in range(len(dataset))]
    examples.sort(key=lambda e: len(e.input_ids_no_response))
    records = []
    latencies = []
    generated = 0
    decode_s = 0.0
    for start in range(0, len(examples), decode_batch):
        chunk = examples[start:start + decode_batch]
        real = len(chunk)
        while len(chunk) < decode_batch:
            chunk.append(chunk[-1])
        longest = max(len(e.input_ids_no_response) for e in chunk)
        target = min(bucket_length(longest), cfg.block_size - max_new_tokens)
        ids = np.zeros((decode_batch, target), np.int64)
        lengths = np.zeros((decode_batch,), np.int64)
        for i, ex in enumerate(chunk):
            p = ex.input_ids_no_response[:target]
            ids[i, :len(p)] = p
            lengths[i] = len(p)
        t0 = time.perf_counter()
        tokens, total_lengths = generate(
            model, torch.from_numpy(ids), torch.from_numpy(lengths),
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, eos_id=eos_id, generator=generator,
        )
        tokens = tokens.cpu().numpy()
        total_lengths = total_lengths.cpu().numpy()
        elapsed = time.perf_counter() - t0
        latencies.extend([elapsed / real] * real)
        generated += int((total_lengths[:real] - lengths[:real]).sum())
        decode_s += elapsed
        for i in range(real):
            ex = chunk[i]
            seq = tokens[i][: int(total_lengths[i])]
            decoded_full = tokenizer.decode(seq)
            decoded_prompt = tokenizer.decode(ids[i][: int(lengths[i])])
            records.append({
                "uid": ex.uid,
                "inference": extract_response(decoded_full, decoded_prompt),
                "ground_truth": ex.ground_truth.strip(),
            })
    metrics = evaluate_predictions(
        [r["inference"] for r in records], [r["ground_truth"] for r in records]
    )
    if collect_latency and latencies:
        metrics["p50_latency_s"] = float(np.percentile(latencies, 50))
        metrics["p90_latency_s"] = float(np.percentile(latencies, 90))
        metrics["generated_tokens"] = generated
        metrics["tokens_per_s"] = generated / decode_s
    return records, metrics


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag in NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported yet")
    if args.scheduler != "lockstep":
        raise NotImplementedError("--scheduler continuous is not ported yet")
    device = resolve_device(args.device)

    checkpoint_dir = Path(args.llm_checkpoint)
    tokenizer = common.load_tokenizer(checkpoint_dir)
    model_cfg = common.model_config_from_args(args)
    model = common.load_model(checkpoint_dir, model_cfg, device=device,
                              seed=args.seed, finetuned=args.model_path)
    dataset = common.dataset_class_for(args)(
        "test",
        args.test_path,
        tokenizer=tokenizer,
        nhyps_key=args.nhyps_key,
        max_nhyps=args.max_nhyps,
        prompts_format=args.prompts_format,
        apply_chat_template=args.apply_chat_template,
        language=args.language,
        seed=args.seed,
    )
    generator = torch.Generator(device=model.device)
    generator.manual_seed(args.seed)
    records, metrics = run_inference(
        model, tokenizer, dataset,
        decode_batch=args.decode_batch,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_k=args.top_k,
        collect_latency=True,
        generator=generator,
    )
    predict_dir = Path(args.model_path).parent / "predictions"
    predict_dir.mkdir(parents=True, exist_ok=True)
    out_path = predict_dir / (Path(args.model_path).stem + ".json")
    with open(out_path, "w", encoding="utf-8") as fp:
        json.dump(records + [metrics], fp, indent=4, ensure_ascii=False)
    print(
        f"WER: {metrics['WER']*100:.2f}  WER_post: {metrics['post_ST_wer']*100:.2f}  "
        f"GTM: {metrics['gtms']*100:.2f}  GTM_post: {metrics['post_gtms']*100:.2f}"
    )
    print(f"Results in {out_path}")


if __name__ == "__main__":
    main()
