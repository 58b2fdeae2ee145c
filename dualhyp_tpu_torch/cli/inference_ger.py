"""GER / DualHyp correction + WER evaluation entry point.

Counterpart of `dualhyp_tpu/cli/inference_ger.py`:

  python -m dualhyp_tpu_torch.cli.inference_ger \\
      --test_path test.json --model_path runs/exp/best_model.npz \\
      --llm_checkpoint checkpoints/TinyLlama/TinyLlama-1.1B-Chat-v1.0 \\
      --dual_hypotheses --prompts_format DualHyp

Protocol parity with the reference (ref: inference/ger.py:71-117):
temperature 0.2, top_k 1 (greedy), max_new 150, EOS stop, prompt-prefix
strip + first line; metrics WER, exact matches, post-normalised WER;
predictions JSON written next to the checkpoint. Decoding is batched
(--decode_batch, default 8). Runs on the card unless --device names another.

--quantize int8|int4 merges the LoRA deltas into the weights, then
quantizes them (int4 runs kernel K8); --kv_quant int8 decodes against an
int8 KV cache. DUALHYP_LORA_IMPL=fused runs the unmerged LoRA linears
through kernel K5. --speculative [lookup|anchored] decodes greedily with
drafts of --draft_len tokens verified in one pass (`infer/decode`,
token-identical to greedy); --scheduler continuous serves the prompts
through the slot pool of `infer/serve.ContinuousBatcher`; --dry_run checks
the hypotheses JSON's ingest without loading weights.

The mesh flags (--dp, --fsdp, --tensor, --expert, --seq; `cli.common.
add_mesh_args`) run it on every rank of a torchrun job, one card a rank:

  torchrun --nproc_per_node 2 -m dualhyp_tpu_torch.cli.inference_ger --tensor 2 ...

The model is each rank's piece (`GPT(mesh=)`); each decode batch shards
over `data x fsdp` when that extent divides it (over `data` alone under
fsdp, whose ranks must step together, since a batch stops when its rows
are done), the tokens are gathered, and rank 0 writes the records, which
equal a one-rank run's.
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
from dualhyp_tpu_torch.infer.decode import (
    find_subsequence_span, generate, generate_anchored, generate_lookup)
from dualhyp_tpu_torch.infer.evaluate import evaluate_predictions, extract_response
from dualhyp_tpu_torch.models.gpt import merge_lora, quantize_model
from dualhyp_tpu_torch.parallel import comm


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
                        help="weight quantization after merging LoRA: int8 "
                             "per row, int4 group-wise (lossy: validate WER "
                             "before serving with it)")
    parser.add_argument("--kv_quant", choices=[None, "int8"], default=None,
                        help="int8 KV cache with per-slot scales (outputs may "
                             "shift within the quantization's rounding)")
    parser.add_argument("--speculative", nargs="?", const="lookup",
                        choices=["lookup", "anchored"], default=None,
                        help="speculative decoding (greedy only; token-"
                             "identical): 'lookup' drafts from suffix n-gram "
                             "matches anywhere in the buffer; 'anchored' "
                             "follows the best-hypothesis span with a "
                             "monotone pointer")
    parser.add_argument("--draft_len", type=int, default=8,
                        help="speculative draft window (tokens verified a "
                             "step = draft_len + 1)")
    parser.add_argument("--scheduler", choices=["lockstep", "continuous"],
                        default="lockstep",
                        help="continuous: slot-based continuous batching "
                             "with speculative decoding (infer/serve.py); "
                             "finished sequences refill at once")
    parser.add_argument("--dry_run", action="store_true",
                        help="validate the hypotheses JSON ingest (schema, "
                             "prompt packing, token lengths) and exit "
                             "without loading model weights")
    common.add_model_args(parser)
    common.add_data_args(parser)
    common.add_mesh_args(parser)
    return parser


def _best_hypothesis_text(ex, dataset):
    """The best ASR hypothesis of a PackedExample (the anchored draft's
    span); '' when there is none."""
    if not getattr(ex, "records", None):
        return ""
    rec = ex.records[0]
    key = getattr(dataset, "nhyps_key_asr", None) or getattr(dataset, "nhyps_key",
                                                             "nhyps_asr")
    try:
        return rec[key]["hyps"][0]
    except (KeyError, IndexError, TypeError):
        return ""


def hypothesis_ids(tokenizer, text):
    """A hypothesis's token ids without special tokens: the span that
    anchored drafting looks for in the prompt."""
    try:  # a BOS would break the span match inside the prompt
        return tokenizer.encode(text, add_special_tokens=False)
    except TypeError:
        return tokenizer.encode(text)


def check_greedy(speculative, scheduler, top_k) -> None:
    """Speculative decoding and the slot pool are greedy only, as in the
    JAX package: raise for sampling (top_k != 1)."""
    if (speculative or scheduler == "continuous") and top_k != 1:
        raise ValueError("--speculative/--scheduler continuous require greedy decoding "
                         "(top_k=1)")


def run_inference(model, tokenizer, dataset, *, decode_batch=8,
                  max_new_tokens=150, temperature=0.2, top_k=1,
                  collect_latency=False, generator=None, kv_quant=None,
                  speculative=None, draft_len=8, scheduler="lockstep"):
    """Batched correction over a dataset. Returns (records, metrics).

    Prompts are sorted by length and decoded `decode_batch` at a time,
    right-padded to the next length bucket; a short last batch repeats its
    last prompt and drops the repeats. Latency is per batch, shared by its
    prompts. collect_latency adds p50/p90 latency, the generated tokens (EOS
    not counted, repeats dropped) and their rate over the decode time.
    kv_quant: "int8" decodes against an int8 KV cache. speculative
    ("lookup" or "anchored", greedy only): `generate_lookup` or
    `generate_anchored` with `draft_len`; collect_latency then adds the
    verify steps and the tokens a row emits a verify step.
    scheduler="continuous": the requests go through a
    `ContinuousBatcher` of `decode_batch` slots (draft source "anchored"
    under speculative="anchored", else "lookup").

    A model on a mesh decodes each batch's rows split over `data x fsdp`
    (`data` under fsdp) where the extent divides decode_batch, and gathers
    the tokens; every rank returns the same records."""
    check_greedy(speculative, scheduler, top_k)
    if scheduler == "continuous":
        return _run_inference_continuous(
            model, tokenizer, dataset, decode_batch=decode_batch,
            max_new_tokens=max_new_tokens, collect_latency=collect_latency,
            draft_len=draft_len, kv_quant=kv_quant,
            draft_source="anchored" if speculative == "anchored" else "lookup")
    cfg = model.cfg
    eos_id = getattr(tokenizer, "eos_token_id", None)
    examples = [dataset[i] for i in range(len(dataset))]
    examples.sort(key=lambda e: len(e.input_ids_no_response))
    split, rows_group, lo = 1, None, 0
    mesh = model.mesh
    if mesh is not None:
        axes = ("data",) if mesh.shape.get("fsdp", 1) > 1 else ("data", "fsdp")
        if decode_batch % mesh.extent(*axes) == 0:
            split, rows_group = mesh.extent(*axes), mesh.group(*axes)
            lo = mesh.index(*axes) * (decode_batch // split)
    local = slice(lo, lo + decode_batch // split)
    records = []
    latencies = []
    generated = 0
    decode_s = 0.0
    verify_steps = row_steps = drafted = 0
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
        if speculative:
            kw = dict(max_new_tokens=max_new_tokens, eos_id=eos_id, draft_len=draft_len,
                      kv_quant=kv_quant, return_steps=True)
            if speculative == "anchored":
                # each row's best-hypothesis span (a zero span falls back
                # to the suffix lookup)
                spans = np.zeros((2, decode_batch), np.int64)
                for i, ex in enumerate(chunk):
                    best = _best_hypothesis_text(ex, dataset)
                    if best:
                        spans[:, i] = find_subsequence_span(
                            list(ids[i][:int(lengths[i])]), hypothesis_ids(tokenizer, best))
                tokens, total_lengths, (steps, emitted) = generate_anchored(
                    model, torch.from_numpy(ids[local]), torch.from_numpy(lengths[local]),
                    torch.from_numpy(spans[0][local]), torch.from_numpy(spans[1][local]), **kw)
            else:
                tokens, total_lengths, (steps, emitted) = generate_lookup(
                    model, torch.from_numpy(ids[local]), torch.from_numpy(lengths[local]),
                    **kw)
            if rows_group is not None:
                emitted = comm._all_gather(torch.as_tensor(emitted), 0, rows_group)
            verify_steps += steps
            row_steps += steps * real
            drafted += int(emitted[:real].sum()) - int((emitted[:real] > 0).sum())
        else:
            tokens, total_lengths = generate(
                model, torch.from_numpy(ids[local]), torch.from_numpy(lengths[local]),
                max_new_tokens=max_new_tokens, temperature=temperature,
                top_k=top_k, eos_id=eos_id, generator=generator, kv_quant=kv_quant,
            )
        if rows_group is not None:
            tokens = comm._all_gather(tokens, 0, rows_group)
            total_lengths = comm._all_gather(total_lengths, 0, rows_group)
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
        if speculative:
            # the tokens a row emits a verify step (the first token of each
            # row comes from the prefill), over every step of its batch
            metrics["verify_steps"] = verify_steps
            metrics["tokens_per_row_verify_step"] = drafted / max(row_steps, 1)
    return records, metrics


def _run_inference_continuous(model, tokenizer, dataset, *, decode_batch, max_new_tokens,
                              collect_latency, draft_len, draft_source="lookup",
                              kv_quant=None):
    """The continuous-batching evaluator: the lockstep path's records and
    metrics, but finished sequences hand their slot to the next prompt at
    once (per-request latency, no straggler wait)."""
    from dualhyp_tpu_torch.infer.serve import ContinuousBatcher

    eos_id = getattr(tokenizer, "eos_token_id", None)
    examples = [dataset[i] for i in range(len(dataset))]
    # the lockstep path's record order (sorted by prompt length)
    examples.sort(key=lambda e: len(e.input_ids_no_response))
    batcher = ContinuousBatcher(model, slots=decode_batch, max_new_tokens=max_new_tokens,
                                draft_len=draft_len, eos_id=eos_id,
                                draft_source=draft_source, kv_quant=kv_quant)

    def hyp_ids(ex):
        """Best-hypothesis tokens for the anchored draft pointer."""
        if draft_source != "anchored":
            return None
        best = _best_hypothesis_text(ex, dataset)
        return hypothesis_ids(tokenizer, best) if best else None

    # the lockstep path's truncation budget (prompt and budget must fit)
    budget = model.cfg.block_size - max_new_tokens
    requests = [(i, list(ex.input_ids_no_response)[:budget], None, hyp_ids(ex))
                for i, ex in enumerate(examples)]
    t0 = time.perf_counter()
    served = batcher.serve(requests)
    decode_s = time.perf_counter() - t0

    records = [None] * len(examples)
    latencies = []
    generated = 0
    for rec in served:
        ex = examples[rec["id"]]
        seq = rec["tokens"]
        generated += len(seq) - rec["prompt_len"]
        records[rec["id"]] = {
            "uid": ex.uid,
            "inference": extract_response(tokenizer.decode(seq),
                                          tokenizer.decode(seq[:rec["prompt_len"]])),
            "ground_truth": ex.ground_truth.strip(),
        }
        latencies.append(rec["latency_s"])
    metrics = evaluate_predictions(
        [r["inference"] for r in records], [r["ground_truth"] for r in records]
    )
    if collect_latency and latencies:
        metrics["p50_latency_s"] = float(np.percentile(latencies, 50))
        metrics["p90_latency_s"] = float(np.percentile(latencies, 90))
        metrics["generated_tokens"] = generated
        metrics["tokens_per_s"] = generated / decode_s
        metrics["chunks"] = batcher.chunks
        metrics["verify_steps"] = batcher.chunks * batcher.chunk_steps
        metrics["host_reads"] = batcher.host_reads
    return records, metrics


def dry_run_ingest(args, tokenizer) -> dict:
    """Load the hypotheses JSON through the whole dataset path (uid
    grouping, prompt packing, label masking) without touching model
    weights: a schema check before spending time on the card."""
    dataset_cls = common.dataset_class_for(args)
    dataset = dataset_cls(
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
    lengths = []
    for i in range(len(dataset)):
        ex = dataset[i]
        assert ex.ground_truth is not None
        lengths.append(len(ex.input_ids_no_response))
    info = {
        "examples": len(dataset),
        "prompt_tokens_min": int(min(lengths)) if lengths else 0,
        "prompt_tokens_p50": int(np.median(lengths)) if lengths else 0,
        "prompt_tokens_max": int(max(lengths)) if lengths else 0,
        "dataset_class": dataset_cls.__name__,
    }
    print(json.dumps(info))
    return info


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_greedy(args.speculative, args.scheduler, args.top_k)  # before the model loads
    checkpoint_dir = Path(args.llm_checkpoint)
    if args.dry_run:
        dry_run_ingest(args, common.load_tokenizer(checkpoint_dir))
        return
    mesh = None
    if common.wants_mesh(args):
        mesh, device = common.mesh_from_args(args)
    else:
        device = resolve_device(args.device)

    tokenizer = common.load_tokenizer(checkpoint_dir)
    model_cfg = common.model_config_from_args(args)
    model = common.load_model(checkpoint_dir, model_cfg, device=device,
                              seed=args.seed, finetuned=args.model_path, mesh=mesh)
    if args.quantize:
        if model_cfg.any_lora:
            merge_lora(model)
        quantize_model(model, args.quantize)
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
        kv_quant=args.kv_quant,
        speculative=args.speculative,
        draft_len=args.draft_len,
        scheduler=args.scheduler,
    )
    if mesh is not None and torch.distributed.get_rank() != 0:
        return  # rank 0 writes the records
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
