"""RelPrompt inference: predict reliability masks, substitute them into the
prompt, re-encode, decode, evaluate.

Counterpart of `dualhyp_tpu/cli/inference_relprompt.py`:

  python -m dualhyp_tpu_torch.cli.inference_relprompt \\
      --test_path test.json --model_path runs/relprompt/best_model.npz \\
      --llm_checkpoint checkpoints/TinyLlama/TinyLlama-1.1B-Chat-v1.0 \\
      --dual_hypotheses --prompts_format RelPrompt \\
      --whisper_checkpoint checkpoints/openai/whisper-large-v3   # or --feature_dir

The mask dataset keeps the `<<<ASR_MASKS>>>` / `<<<VSR_MASKS>>>` placeholders
(leave_masks=True); per request the two classifiers run over the frozen
encoder features, their argmax classes become `<<C>>`-style tokens, the
placeholders are replaced and the prompt is re-encoded; then decoding and
the WER protocol of `cli.inference_ger`, with the mask classification
metrics beside. Runs on the card unless --device names another: the Whisper
encoder there runs kernel K6 in each layer, the decode path K1 forward, K2,
K3 and K4.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from dualhyp_tpu_torch.cli import common
from dualhyp_tpu_torch.cli.finetune_relprompt import feature_loader
from dualhyp_tpu_torch.cli.inference_ger import check_greedy, run_inference
from dualhyp_tpu_torch.data import masks as mask_lib
from dualhyp_tpu_torch.data.hypotheses import DualHypothesesMaskDataset
from dualhyp_tpu_torch.data.prompts import MASK_TOKENS
from dualhyp_tpu_torch.device import resolve_device
from dualhyp_tpu_torch.models import relprompt as rp

_CLASS_TOKENS = ["<<C>>", "<<M>>", "<<N>>"]


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--test_path", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--seed", type=int, default=1337)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; raises "
                             "without one)")
    parser.add_argument("--decode_batch", type=int, default=8)
    parser.add_argument("--max_new_tokens", type=int, default=150)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top_k", type=int, default=1)
    parser.add_argument("--speculative", action="store_true",
                        help="prompt-lookup speculative decoding (greedy only, "
                             "token-identical; see inference_ger)")
    parser.add_argument("--draft_len", type=int, default=8)
    parser.add_argument("--scheduler", choices=["lockstep", "continuous"],
                        default="lockstep",
                        help="continuous: slot-based continuous batching with "
                             "speculative decoding (infer/serve.py)")
    parser.add_argument("--mask_threshold", type=float, default=None)
    parser.add_argument("--time_window", type=float, default=0.4)
    parser.add_argument("--feature_dir", type=str, default=None)
    parser.add_argument("--synthetic_features", action="store_true")
    parser.add_argument("--whisper_checkpoint", type=str, default=None)
    common.add_model_args(parser)
    common.add_data_args(parser)
    return parser


def predict_masks(model, cfg, example, loader, rng):
    """Run both classifiers; return (audio_tokens, visual_tokens, class ids)."""
    audio_feats, visual_feats = loader(example, rng)
    device = model.device
    a_logits = model.audio_noise_classifier(
        torch.from_numpy(np.asarray(audio_feats, np.float32)[None]).to(device),
        2 * cfg.classifier_pool_size)
    v_logits = model.visual_noise_classifier(
        torch.from_numpy(np.asarray(visual_feats, np.float32)[None]).to(device),
        cfg.classifier_pool_size)
    a_ids = a_logits[0].argmax(-1).cpu().numpy()
    v_ids = v_logits[0].argmax(-1).cpu().numpy()
    a_tokens = [_CLASS_TOKENS[i] for i in a_ids]
    v_tokens = [_CLASS_TOKENS[i] for i in v_ids]
    return a_tokens, v_tokens, a_ids, v_ids


def substitute_and_encode(tokenizer, example, a_tokens, v_tokens):
    """String-replace the mask placeholders and re-encode."""
    prompt = example.prompt_no_response.replace(
        "<<<ASR_MASKS>>>", "".join(a_tokens)
    ).replace("<<<VSR_MASKS>>>", "".join(v_tokens))
    return prompt, list(tokenizer.encode(prompt))


def add_mask_tokens(tokenizer) -> None:
    """`<<C>>`, `<<M>>`, `<<N>>` as special tokens: an HF tokenizer takes a
    dict, the package's `Tokenizer` a list."""
    try:
        tokenizer.add_special_tokens({"additional_special_tokens": MASK_TOKENS})
    except TypeError:
        tokenizer.add_special_tokens(MASK_TOKENS)


def run_relprompt(model, tokenizer, dataset, loader, *, seed=1337, decode_batch=8,
                  max_new_tokens=150, temperature=0.2, top_k=1, generator=None,
                  speculative=False, draft_len=8, scheduler="lockstep"):
    """Masks predicted and substituted for every request of `dataset` (a
    `DualHypothesesMaskDataset` with leave_masks=True), then batched
    correction (`cli.inference_ger.run_inference`; speculative: prompt
    lookup drafts of `draft_len`; scheduler "continuous": the slot pool).
    Returns (records, metrics with the mask metrics beside, {uid: (audio
    tokens, visual tokens)})."""
    cfg = model.cfg
    feat_rng = np.random.default_rng(seed)
    all_pred, all_targ = [], []
    examples, masks = [], {}
    for i in range(len(dataset)):
        ex = dataset[i]
        a_tokens, v_tokens, a_ids, v_ids = predict_masks(model, cfg, ex, loader, feat_rng)
        prompt, ids = substitute_and_encode(tokenizer, ex, a_tokens, v_tokens)
        ex.prompt_no_response = prompt
        ex.input_ids_no_response = ids
        gt_a = mask_lib.bins_to_indices(ex.audio_bin_labels)
        gt_v = mask_lib.bins_to_indices(ex.video_bin_labels)
        ta = min(len(a_ids), len(gt_a))
        tv = min(len(v_ids), len(gt_v))
        all_pred.extend(list(a_ids[:ta]) + list(v_ids[:tv]))
        all_targ.extend(gt_a[:ta] + gt_v[:tv])
        examples.append(ex)
        masks[ex.uid] = (a_tokens, v_tokens)

    records, metrics = run_inference(
        model, tokenizer, examples, decode_batch=decode_batch,
        max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
        collect_latency=True, generator=generator,
        speculative="lookup" if speculative else None, draft_len=draft_len,
        scheduler=scheduler)
    metrics.update({f"mask_{k}": v for k, v in rp.mask_metrics(
        np.asarray(all_pred), np.asarray(all_targ)).items()})
    return records, metrics, masks


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_greedy(args.speculative, args.scheduler, args.top_k)  # before the model loads
    device = resolve_device(args.device)
    args.device = str(device)

    checkpoint_dir = Path(args.llm_checkpoint)
    tokenizer = common.load_tokenizer(checkpoint_dir)
    add_mask_tokens(tokenizer)
    model_cfg = common.model_config_from_args(args, relprompt=True)
    model = common.load_model(checkpoint_dir, model_cfg, device=device, seed=args.seed,
                              finetuned=args.model_path)
    dataset = DualHypothesesMaskDataset(
        "test",
        args.test_path,
        tokenizer=tokenizer,
        max_nhyps=args.max_nhyps,
        prompts_format=args.prompts_format or "RelPrompt",
        apply_chat_template=args.apply_chat_template,
        language=args.language,
        seed=args.seed,
        leave_masks=True,
        mask_threshold=args.mask_threshold,
        time_window=args.time_window,
        audio_corruption_enabled=not args.audio_corruption_disabled,
        visual_corruption_enabled=not args.visual_corruption_disabled,
    )
    loader = feature_loader(args, model_cfg)
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)
    records, metrics, _ = run_relprompt(
        model, tokenizer, dataset, loader, seed=args.seed,
        decode_batch=args.decode_batch, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, top_k=args.top_k, generator=generator,
        speculative=args.speculative, draft_len=args.draft_len, scheduler=args.scheduler)
    predict_dir = Path(args.model_path).parent / "predictions"
    predict_dir.mkdir(parents=True, exist_ok=True)
    out_path = predict_dir / (Path(args.model_path).stem + "_relprompt.json")
    with open(out_path, "w", encoding="utf-8") as fp:
        json.dump(records + [metrics], fp, indent=4, ensure_ascii=False)
    print(
        f"WER: {metrics['WER']*100:.2f}  mask acc: {metrics['mask_acc']*100:.2f}  "
        f"mask F1: {metrics['mask_f1']*100:.2f}"
    )
    print(f"Results in {out_path}")


if __name__ == "__main__":
    main()
