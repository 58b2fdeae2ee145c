"""GER / DualHyp finetuning entry point: LoRA, adapter v1 / v2 or full.

Counterpart of `dualhyp_tpu/cli/finetune_ger.py`:

  python -m dualhyp_tpu_torch.cli.finetune_ger \\
      --train_path train.json --val_path val.json \\
      --llm_checkpoint checkpoints/TinyLlama/TinyLlama-1.1B-Chat-v1.0 \\
      --dual_hypotheses --prompts_format DualHyp --exp_name my_run
  # N cards, one rank a card (the mesh flags)
  torchrun --nproc_per_node N -m dualhyp_tpu_torch.cli.finetune_ger --tensor 2 ...

The same flags as the JAX package's, the mesh flags --dp / --fsdp /
--tensor / --expert / --seq included (`parallel`; without --dp, the
largest data extent that divides the micro batch, the JAX package's rule;
the job must hold that many ranks), plus --device (default: the CUDA card,
`cuda:LOCAL_RANK` under torchrun; raises without one) and
--save_adapter_only. On a mesh every rank runs the loop and rank 0 writes
the files and the log. --mode adapter|adapter_v2|full trains
the adapter leaves or every weight (`Trainer`). bf16 compute, frozen
leaves in bf16,
remat on by default (whole blocks; `TrainConfig.remat` also takes "mlp"
and "moe"). An MoE
checkpoint trains through the path `DUALHYP_MOE_IMPL` picks, as `GPT`
reads it ("megablox" or "sparse": the grouped matmul L2 and its gradient).
Writes runs/<exp_name>/: `best_model.npz` on the best validation loss, the
final `model_lora_finetuned.npz` (the reference's best/final pair, ref:
finetune/ger.py:207-209,302-317), `train_state.npz` at each epoch's end for
--resume, and `train_state_diverged.npz` if the loss stops being finite.
The best and final files hold the whole tree, as the JAX package's CLI
writes them; --save_adapter_only writes the trainable (LoRA) leaves alone,
as the JAX package's `ckpt.io.save_adapter_only` does, and they load over
the base checkpoint through --model_path the same way (the whole tree of a
16-layer Mixtral is 47 GB a file, its LoRA leaves 27 MB).
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import torch

from dualhyp_tpu_torch.cli import common
from dualhyp_tpu_torch.ckpt.io import save_params
from dualhyp_tpu_torch.data import collate
from dualhyp_tpu_torch.device import resolve_device
from dualhyp_tpu_torch.train import TrainConfig, Trainer
from dualhyp_tpu_torch.utils import SpeedMonitor, StepLogger, setup_run_logger


class _Quiet:
    """The log of a rank that does not write (a mesh's ranks but 0)."""

    def info(self, *args, **kwargs):
        pass


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_path", type=str, nargs="+")
    parser.add_argument("--val_path", type=str)
    parser.add_argument("--exp_name", type=str, default="finetune")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--micro_batch_size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--num_epochs", type=int, default=5)
    parser.add_argument("--weight_decay", type=float, default=0.02)
    parser.add_argument("--wp", type=float, default=0.2)
    parser.add_argument("--use_cosine_scheduler", action="store_true")
    parser.add_argument("--min_lr_ratio", type=float, default=0.01)
    parser.add_argument("--log_interval", type=int, default=100)
    parser.add_argument("--save_interval", type=int, default=10000)
    parser.add_argument("--seed", type=int, default=1337)
    parser.add_argument("--remat", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="activation rematerialisation of whole blocks")
    parser.add_argument("--save_adapter_only", action="store_true",
                        help="best_model.npz and model_lora_finetuned.npz hold "
                             "the trainable leaves alone (default: the whole tree)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from runs/<exp>/train_state.npz "
                             "(optimizer moments + LR clock; exact resume)")
    parser.add_argument("--data_prefetch", action="store_true",
                        help="producer-thread batch pipeline: overlaps "
                             "host-side wav/ROI loading with the card's work "
                             "(use when corruption is enabled; disables "
                             "length-sorted batching)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; raises "
                             "without one)")
    common.add_model_args(parser)
    common.add_data_args(parser)
    common.add_mesh_args(parser)
    return parser


def _saved_tree(trainer, adapter_only: bool) -> dict:
    return trainer.trainable_params if adapter_only else trainer.params


def _save(trainer, path, adapter_only: bool) -> None:
    """The best or final file: every rank gathers the tree, rank 0 writes."""
    tree = _saved_tree(trainer, adapter_only)
    if trainer.lead:
        save_params(path, tree)


def _validate_and_save(trainer, val_ds, tcfg, out_dir, best_val, logger, adapter_only):
    batches = collate.epoch_batches(
        val_ds, tcfg.micro_batch_size, shuffle=False, seed=0, epoch=0)
    val_loss = trainer.evaluate(batches)
    logger.info(f"val loss {val_loss:.4f}")
    if val_loss < best_val:
        best_val = val_loss
        _save(trainer, out_dir / "best_model.npz", adapter_only)
        logger.info("best model saved")
    return best_val


def _vocab_size(tokenizer):
    return len(tokenizer) if hasattr(tokenizer, "__len__") else tokenizer.vocab_size


def run_training(model, tokenizer, train_ds, val_ds, tcfg: TrainConfig, out_dir, *,
                 generator: torch.Generator, resume: bool = False, logger=None,
                 on_step=None, adapter_only: bool = False,
                 data_prefetch: bool = False) -> dict:
    """The finetuning loop of the JAX package's `main`, on `model`'s device.

    Epochs of length-sorted, seeded batches (`collate.epoch_batches`); a
    validation and a `best_model.npz` every `save_interval` micro-steps and
    at the end; `train_state.npz` at each epoch's end; the final weights in
    `model_lora_finetuned.npz`. The LoRA dropout of epoch e draws from a CPU
    generator seeded with s + e, s one draw from `generator`, so a resumed
    run repeats the uninterrupted run's masks. Raises SystemExit, with the
    state saved to `train_state_diverged.npz`, when a logged loss is not
    finite. on_step(opt_step, loss, lr): called after each optimizer step.
    adapter_only (--save_adapter_only): the best and final files hold the
    trainable leaves alone, not the whole tree. data_prefetch
    (--data_prefetch): the batches come from `collate.prefetch_epoch_batches`
    (a producer thread, no length sorting). Returns {"trainer",
    "losses" (device scalars), "lrs", "best_val", "max_iters",
    "warmup_steps"}. A model on a mesh (`GPT(mesh=)`) trains on its mesh;
    every rank calls this, rank 0 writes the files."""
    out_dir = Path(out_dir)
    lead = model.mesh is None or torch.distributed.get_rank() == 0
    if logger is None:
        logger = setup_run_logger(out_dir) if lead else _Quiet()
    if _vocab_size(tokenizer) > model.cfg.padded_vocab_size:
        raise ValueError(f"tokenizer has {_vocab_size(tokenizer)} tokens, the model "
                         f"{model.cfg.padded_vocab_size}")
    step_logger = StepLogger(out_dir)
    monitor = SpeedMonitor()
    # a pipeline's stages bring their own mesh (model.mesh)
    trainer = Trainer(model.cfg, tcfg, model,
                      mesh=model.mesh if tcfg.pipeline_stages == 1 else None,
                      monitor=monitor, logger=step_logger)
    logger.info(f"mode {tcfg.mode}: trainable params "
                f"{model.count_params(True, tcfg.mode):,} / {model.count_params():,}")

    # schedule bookkeeping in micro-iteration units (ref: finetune/ger.py:176-182)
    steps_per_epoch = max(len(train_ds) // tcfg.batch_size, 1)
    max_iters = tcfg.num_epochs * steps_per_epoch * tcfg.grad_accum
    warmup_steps = max(int(steps_per_epoch * tcfg.grad_accum * tcfg.warmup_fraction), 1)
    dropout_seed = int(torch.randint(0, 2**62, (1,), generator=generator))

    best_val = float("inf")
    losses, lrs = [], []
    t_start = time.perf_counter()
    state_path = out_dir / "train_state.npz"
    start_epoch = 0
    opt_step = 0
    if resume and state_path.is_file():
        extra = trainer.load_train_state(state_path)
        start_epoch = extra.get("epoch", -1) + 1
        opt_step = trainer.opt_step
        logger.info(f"resumed from {state_path}: epoch {start_epoch}, "
                    f"opt_step {opt_step}, micro_iter {trainer.micro_iter}")

    log_every = max(tcfg.log_interval // tcfg.grad_accum, 1)
    save_every = max(tcfg.save_interval // tcfg.grad_accum, 1)
    for epoch in range(start_epoch, tcfg.num_epochs):
        epoch_gen = torch.Generator().manual_seed(dropout_seed + epoch)
        if data_prefetch:
            batches = collate.prefetch_epoch_batches(
                train_ds, tcfg.batch_size, shuffle=True, seed=tcfg.seed, epoch=epoch)
        else:
            batches = collate.epoch_batches(
                train_ds, tcfg.batch_size, shuffle=True, seed=tcfg.seed, epoch=epoch,
                length_sorted=True)
        for batch in batches:
            # monitor + CSV step logging happen inside train_step
            loss, lr = trainer.train_step(batch, max_iters, warmup_steps, epoch_gen)
            opt_step += 1
            losses.append(loss)
            lrs.append(lr)
            if on_step is not None:
                on_step(opt_step, loss, lr)
            if opt_step % log_every == 0:
                stats = monitor.stats()
                avg = step_logger.rows[opt_step]["loss"]  # train_step's window mean
                if not math.isfinite(avg):
                    # stop with the resume state intact instead of burning
                    # epochs on NaN
                    trainer.save_train_state(out_dir / "train_state_diverged.npz",
                                             extra={"epoch": epoch})
                    raise SystemExit(
                        f"loss became non-finite at step {opt_step} (lr {lr:.2e}); "
                        f"state saved to train_state_diverged.npz: resume from the "
                        f"last epoch checkpoint with --resume (lower lr or raise "
                        f"warmup)")
                logger.info(
                    f"step {opt_step}: loss {avg:.4f} lr {lr:.2e} "
                    f"tok/s {stats.get('tokens_per_sec', 0):,.0f} "
                    f"mfu {stats.get('mfu', 0):.3f}")
            if opt_step % save_every == 0:
                best_val = _validate_and_save(trainer, val_ds, tcfg, out_dir,
                                              best_val, logger, adapter_only)
        if lead:
            step_logger.save()
        # epoch-boundary resume point (optimizer moments + LR clock)
        trainer.save_train_state(state_path, extra={"epoch": epoch})

    best_val = _validate_and_save(trainer, val_ds, tcfg, out_dir, best_val, logger,
                                  adapter_only)
    _save(trainer, out_dir / "model_lora_finetuned.npz", adapter_only)
    logger.info(f"training done in {time.perf_counter() - t_start:.1f}s; "
                f"best val loss {best_val:.4f}")
    if lead:
        step_logger.save()
    return {"trainer": trainer, "losses": losses, "lrs": lrs, "best_val": best_val,
            "max_iters": max_iters, "warmup_steps": warmup_steps}


def _data_extent(args):
    """--dp, or the largest data extent that divides the micro batch (with
    fsdp) within the job's ranks (the JAX package's rule); the job must
    hold exactly the mesh's ranks (`common.mesh_from_args`)."""
    import os

    model_axes = args.fsdp * args.tensor * args.expert * args.seq
    world = (torch.distributed.get_world_size() if torch.distributed.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    dp = args.dp
    if dp is None:
        dp = 1
        for cand in range(1, world // model_axes + 1):
            if args.micro_batch_size % (cand * args.fsdp) == 0:
                dp = cand
    return dp


def main(argv=None):
    args = build_parser().parse_args(argv)
    mesh = None
    if common.wants_mesh(args):
        mesh, device = common.mesh_from_args(args, dp=_data_extent(args))
    else:
        device = resolve_device(args.device)
    out_dir = Path(f"./runs/{args.exp_name}")
    lead = mesh is None or torch.distributed.get_rank() == 0
    logger = setup_run_logger(out_dir) if lead else _Quiet()
    logger.info(f"CLI arguments: {vars(args)}")
    if mesh is not None:
        logger.info(f"mesh: {mesh.shape}, backend {torch.distributed.get_backend()}")

    checkpoint_dir = Path(args.llm_checkpoint)
    common.check_valid_checkpoint_dir(checkpoint_dir)
    tokenizer = common.load_tokenizer(checkpoint_dir)
    model_cfg = common.model_config_from_args(args)
    max_input_length = common.max_input_length_from_checkpoint(checkpoint_dir)
    logger.info(f"model config: {model_cfg.name}; max_input_length={max_input_length}")

    tcfg = TrainConfig(
        learning_rate=args.lr,
        weight_decay=args.weight_decay,
        batch_size=args.batch_size,
        micro_batch_size=args.micro_batch_size,
        num_epochs=args.num_epochs,
        warmup_fraction=args.wp,
        use_cosine=args.use_cosine_scheduler,
        min_lr_ratio=args.min_lr_ratio,
        max_input_length=max_input_length,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
        seed=args.seed,
        frozen_dtype="bfloat16",
        remat=args.remat,
        mode=args.mode,
    )
    model = common.load_model(checkpoint_dir, model_cfg, device=device, seed=args.seed,
                              dtype=getattr(torch, tcfg.compute_dtype), mesh=mesh)

    dataset_cls = common.dataset_class_for(args)
    ds_kwargs = dict(
        tokenizer=tokenizer,
        nhyps_key=args.nhyps_key,
        max_input_length=max_input_length,
        max_nhyps=args.max_nhyps,
        prompts_format=args.prompts_format,
        apply_chat_template=args.apply_chat_template,
        language=args.language,
        seed=args.seed,
    )
    train_ds = dataset_cls("train", args.train_path, **ds_kwargs)
    val_ds = dataset_cls("val", args.val_path, **ds_kwargs)
    generator = torch.Generator().manual_seed(args.seed)
    run_training(model, tokenizer, train_ds, val_ds, tcfg, out_dir,
                 generator=generator, resume=args.resume, logger=logger,
                 adapter_only=args.save_adapter_only, data_prefetch=args.data_prefetch)


if __name__ == "__main__":
    main()
