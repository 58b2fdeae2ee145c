"""RelPrompt finetuning entry point.

Counterpart of `dualhyp_tpu/cli/finetune_relprompt.py` (ref:
finetune/relprompt.py:613-683):

  python -m dualhyp_tpu_torch.cli.finetune_relprompt \\
      --train_path train.json --val_path val.json \\
      --dual_hypotheses --prompts_format RelPrompt \\
      --lr 2e-4 --classifier_lr 1e-4

The three reliability tokens <<C>>/<<M>>/<<N>> are appended to the
tokenizer and the embedding table (rows N(0, std(existing rows)) from a
generator seeded with --seed, ref: :120,168); the two classifiers start
from the same generator. Training optimises llm_loss + mask_loss_weight *
(audio + visual mask CE) with separate LLM and classifier learning rates
(`train/relprompt.py`, ref: :174-195,389-403): bf16 compute, frozen leaves
(`wte` with its new rows too) in bf16, remat on, one optimizer step a batch
of --micro_batch_size, length-sorted epoch batches. Writes runs/<exp_name>/:
`best_model.npz` on the best validation LLM loss, the final
`model_relprompt_finetuned.npz` (whole trees in the JAX package's npz
layout), and `train_state.npz` at each epoch's end for --resume (both
groups' AdamW moments, the micro-iteration clock, the epoch). Runs on the
card unless --device names another.

Encoder features, which RelPrompt inference (`cli.inference_relprompt`)
reads through the same functions:

  * `--whisper_checkpoint`: frozen Whisper features computed on the card
    (`models.whisper.encode`, kernel K6 in every layer), the waveform loaded
    and its recorded corruption replayed on the host; visual features from
    `--feature_dir` when given, else zeros;
  * `--feature_dir`: `<uid>.npz` files with `audio` (T, 1280) and `visual`
    (T, 1024) arrays, as `cli.precompute_features` writes them;
  * `--synthetic_features`: seeded noise of the right lengths (pipeline
    checks only).
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np
import torch

from dualhyp_tpu_torch.cli import common
from dualhyp_tpu_torch.data import masks as mask_lib
from dualhyp_tpu_torch.device import resolve_device


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_path", type=str, nargs="+")
    parser.add_argument("--val_path", type=str)
    parser.add_argument("--exp_name", type=str, default="relprompt")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--micro_batch_size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--classifier_lr", type=float, default=1e-4)
    parser.add_argument("--mask_loss_weight", type=float, default=0.02)
    parser.add_argument("--mask_threshold", type=float, default=None)
    parser.add_argument("--time_window", type=float, default=0.4)
    parser.add_argument("--num_epochs", type=int, default=5)
    parser.add_argument("--weight_decay", type=float, default=0.02)
    parser.add_argument("--wp", type=float, default=0.2)
    parser.add_argument("--use_cosine_scheduler", action="store_true")
    parser.add_argument("--log_interval", type=int, default=100)
    parser.add_argument("--save_interval", type=int, default=10000)
    parser.add_argument("--seed", type=int, default=1337)
    parser.add_argument("--feature_dir", type=str, default=None)
    parser.add_argument("--synthetic_features", action="store_true")
    parser.add_argument("--whisper_checkpoint", type=str, default=None,
                        help="HF whisper dir: compute audio features on the card "
                             "(visual features still need --feature_dir)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from runs/<exp>/train_state.npz "
                             "(optimizer moments + LR clock, exact)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; raises "
                             "without one)")
    common.add_model_args(parser)
    common.add_data_args(parser)
    # no mesh flags: the RelPrompt trainer runs on one device
    return parser


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


def main(argv=None, on_step=None) -> dict:
    """Finetune as the flags say. on_step(opt_step, out): called after each
    optimizer step with `train_step`'s output. Returns {"trainer", "steps"
    (each step's output), "best_llm", "validation" (the last metrics),
    "max_iters", "warmup_steps"}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    out_dir = Path(f"./runs/{args.exp_name}")

    from dualhyp_tpu_torch.ckpt.io import save_params
    from dualhyp_tpu_torch.cli.inference_relprompt import add_mask_tokens
    from dualhyp_tpu_torch.data import collate
    from dualhyp_tpu_torch.data.hypotheses import DualHypothesesMaskDataset
    from dualhyp_tpu_torch.models.relprompt import init_relprompt_leaves
    from dualhyp_tpu_torch.train.relprompt import RelPromptTrainConfig, RelPromptTrainer
    from dualhyp_tpu_torch.utils import StepLogger, setup_run_logger

    logger = setup_run_logger(out_dir)
    step_logger = StepLogger(out_dir)
    logger.info(f"CLI arguments: {vars(args)}")

    checkpoint_dir = Path(args.llm_checkpoint)
    tokenizer = common.load_tokenizer(checkpoint_dir)
    add_mask_tokens(tokenizer)
    model_cfg = common.model_config_from_args(args, relprompt=True)
    max_input_length = common.max_input_length_from_checkpoint(checkpoint_dir)
    tcfg = RelPromptTrainConfig(
        mode=args.mode,
        learning_rate=args.lr,
        classifier_learning_rate=args.classifier_lr,
        mask_loss_weight=args.mask_loss_weight,
        weight_decay=args.weight_decay,
        batch_size=args.micro_batch_size,
        micro_batch_size=args.micro_batch_size,
        num_epochs=args.num_epochs,
        warmup_fraction=args.wp,
        use_cosine=args.use_cosine_scheduler,
        max_input_length=max_input_length,
        seed=args.seed,
        frozen_dtype="bfloat16",
        remat=True,
    )
    model = common.load_model(checkpoint_dir, model_cfg, device=device, seed=args.seed,
                              dtype=getattr(torch, tcfg.compute_dtype))
    # the classifiers and the mask-token rows, from a generator of their own
    init_relprompt_leaves(model, torch.Generator(device=device).manual_seed(args.seed))

    ds_kwargs = dict(
        tokenizer=tokenizer,
        max_input_length=max_input_length,
        max_nhyps=args.max_nhyps,
        prompts_format=args.prompts_format,
        apply_chat_template=args.apply_chat_template,
        language=args.language,
        seed=args.seed,
        mask_threshold=args.mask_threshold,
        time_window=args.time_window,
        audio_corruption_enabled=not args.audio_corruption_disabled,
        visual_corruption_enabled=not args.visual_corruption_disabled,
    )
    train_ds = DualHypothesesMaskDataset("train", args.train_path, **ds_kwargs)
    val_ds = DualHypothesesMaskDataset("val", args.val_path, **ds_kwargs)

    trainer = RelPromptTrainer(model_cfg, tcfg, model)
    logger.info(f"mode {tcfg.mode}: trainable params (classifiers included) "
                f"{model.count_params(True, tcfg.mode):,} / {model.count_params():,}")
    loader = feature_loader(args, model_cfg)
    feat_rng = np.random.default_rng(args.seed)

    steps_per_epoch = max(len(train_ds) // tcfg.batch_size, 1)
    max_iters = args.num_epochs * steps_per_epoch
    warmup_steps = max(int(steps_per_epoch * args.wp), 1)
    # the dropout streams: one seed, then a CPU generator an epoch for the
    # LoRA dropout and one for the classifiers' (an exact resume repeats
    # the uninterrupted run's masks)
    dropout_seed = int(torch.randint(0, 2**62, (1,),
                                     generator=torch.Generator().manual_seed(args.seed)))

    best_llm = float("inf")
    steps = []
    opt_step = 0
    state_path = out_dir / "train_state.npz"
    start_epoch = 0
    if args.resume and state_path.is_file():
        extra = trainer.load_train_state(state_path)
        start_epoch = extra.get("epoch", -1) + 1
        opt_step = trainer.opt_step
        logger.info(f"resumed from {state_path}: epoch {start_epoch}")
    for epoch in range(start_epoch, args.num_epochs):
        lora_gen = torch.Generator().manual_seed(dropout_seed + 2 * epoch)
        cls_gen = torch.Generator(device=device).manual_seed(dropout_seed + 2 * epoch + 1)
        for batch in collate.epoch_batches(train_ds, tcfg.batch_size, shuffle=True,
                                           seed=args.seed, epoch=epoch, length_sorted=True):
            batch.update(build_feature_batch(batch["examples"], loader, feat_rng, model_cfg))
            out = trainer.train_step(batch, max_iters, warmup_steps, lora_gen, cls_gen)
            opt_step += 1
            steps.append(out)
            if on_step is not None:
                on_step(opt_step, out)
            if opt_step % args.log_interval == 0:
                out = {k: float(v) for k, v in out.items()}  # a sync
                if not math.isfinite(out["loss"]):
                    trainer.save_train_state(out_dir / "train_state_diverged.npz",
                                             extra={"epoch": epoch})
                    raise SystemExit(
                        f"loss became non-finite at step {opt_step}; state saved to "
                        f"train_state_diverged.npz")
                logger.info(
                    f"step {opt_step}: loss {out['loss']:.4f} "
                    f"llm {out['llm_loss']:.4f} mask {out['mask_loss']:.4f} "
                    f"llm_lr {out['lr']:.2e} cls_lr {out['classifier_lr']:.2e}")
                step_logger.log(opt_step, **out)
            if opt_step % args.save_interval == 0:
                best_llm, metrics = _validate(trainer, val_ds, loader, feat_rng,
                                              model_cfg, tcfg, out_dir, best_llm, logger)
        trainer.save_train_state(state_path, extra={"epoch": epoch})
    best_llm, metrics = _validate(trainer, val_ds, loader, feat_rng, model_cfg, tcfg,
                                  out_dir, best_llm, logger)
    save_params(out_dir / "model_relprompt_finetuned.npz", trainer.params)
    step_logger.save()
    logger.info(f"done; best llm val loss {best_llm:.4f}")
    return {"trainer": trainer, "steps": steps, "best_llm": best_llm,
            "validation": metrics, "max_iters": max_iters, "warmup_steps": warmup_steps}


def _validate(trainer, val_ds, loader, feat_rng, model_cfg, tcfg, out_dir, best_llm,
              logger):
    """Validation metrics; `best_model.npz` (the whole tree) when the LLM
    loss is the best so far. Returns (the best LLM loss, the metrics)."""
    from dualhyp_tpu_torch.ckpt.io import save_params
    from dualhyp_tpu_torch.data import collate

    batches = []
    for batch in collate.epoch_batches(val_ds, tcfg.micro_batch_size, shuffle=False,
                                       seed=0, epoch=0):
        batch.update(build_feature_batch(batch["examples"], loader, feat_rng, model_cfg))
        batches.append(batch)
    metrics = trainer.validate(batches)
    logger.info(
        f"val llm loss {metrics['llm_loss']:.4f} mask acc {metrics['acc']:.4f} "
        f"P {metrics['precision']:.4f} R {metrics['recall']:.4f} F1 {metrics['f1']:.4f}")
    if metrics["llm_loss"] < best_llm:
        best_llm = metrics["llm_loss"]
        save_params(out_dir / "best_model.npz", trainer.params)
        logger.info("best model saved (llm loss)")
    return best_llm, metrics


if __name__ == "__main__":
    main()
