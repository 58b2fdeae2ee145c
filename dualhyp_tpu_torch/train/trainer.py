"""Training harness: finetuning steps, grad accumulation, LR schedule.

Counterpart of `dualhyp_tpu/train/trainer.py` on one card (ref:
finetune/ger.py:212-329, finetune/adapter.py, finetune/adapter_v2.py,
finetune/full.py):

  * gradient accumulation is a loop over micro-batches whose gradients sum
    into `.grad` and are divided by the count before the optimizer step
    (the JAX package's `lax.scan` over micro-batches);
  * `mode` "lora", "adapter" or "adapter_v2" trains the config's PEFT
    leaves (LoRA, adapter v1's prefix and gates, adapter v2's scales,
    biases and norms: `GPT.trainable_parameters`), "full" every floating
    leaf; trainable leaves are fp32 masters, cast to the compute dtype at
    use (mode "full" turns the compute-dtype weights into masters); the
    frozen leaves may be stored in a lower `frozen_dtype`, norm scales
    included, as the JAX trainer's tree cast does;
  * AdamW (`AdamW`) as optax's `adamw` computes it: betas .9/.999, eps
    1e-8, decoupled weight decay on every trainable leaf reading the
    pre-update parameter, and `mu_dtype` ("bfloat16": the first moment
    stored in bf16, updated in fp32 from the stored value);
  * LR: linear warmup, then constant or cosine, in micro-iteration units
    (ref: finetune/ger.py:254-270), set after the clock advances by the
    step's micro-batches;
  * loss: CE of hidden[:, :-1] against labels[:, 1:] with the reference's
    mean-over-all-tokens training normalisation (ref: finetune/ger.py:278-
    281), chunked over the head unless the head has LoRA or adapter v2's
    wrap; it stays a device tensor, so a step waits on no host sync.

On a mesh (`Trainer(mesh=)`, `parallel.make_mesh`) the model is the rank's
local piece (`GPT(mesh=)`) and the step follows the JAX package's sharded
step (`_shard_batch`): this rank takes its rows of `data x fsdp` and, where
T divides, its tokens of `seq`. The labels are shifted before the tokens
are split, so that the pair (hidden[t], labels[t + 1]) never crosses a
shard. The loss is each rank's sum over its tokens over the global count
(every position for the reference's training mean, the valid targets in
evaluation), the logits formed whole (vocab gathered under tensor
parallelism, no chunking). The gradients sum over `data x seq`, and over
`fsdp` for the leaves that fsdp does not shard (the gather's backward has
reduce-scattered the others); AdamW steps each rank's shards, which equals
the replicated step since it is elementwise. With `pipeline_stages` > 1
the trainer builds its own (data, pipe) mesh (`parallel.make_pipe_mesh`),
which does not compose with fsdp / tensor / expert (the JAX package's
assertion), and runs the block stack through `parallel.pipeline`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from dualhyp_tpu_torch.ckpt import io as ckpt_io
from dualhyp_tpu_torch.ckpt.convert import (
    flat_from_named, load_tree, named_from_flat, params_from_jax, tree_from_model)
from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.models.gpt import GPT
from dualhyp_tpu_torch.ops.cross_entropy import (
    IGNORE_INDEX, _token_ce, chunked_cross_entropy, cross_entropy)
from dualhyp_tpu_torch.parallel import comm, pipeline, sharding
from dualhyp_tpu_torch.utils.monitor import estimate_train_flops_per_token


def lr_at_step(step, *, base_lr, warmup_steps, max_iters,
               use_cosine=False, min_lr_ratio=0.01) -> float:
    """The JAX package's schedule, in its float32 arithmetic."""
    f32 = np.float32
    step = f32(step)
    if step <= warmup_steps:
        return float(f32(base_lr) * step / f32(max(warmup_steps, 1)))
    if not use_cosine:
        return float(f32(base_lr))
    progress = (step - f32(warmup_steps)) / f32(max(max_iters - warmup_steps, 1))
    progress = np.clip(progress, f32(0.0), f32(1.0))
    min_lr = f32(base_lr) * f32(min_lr_ratio)
    cos = f32(1.0) + np.cos(f32(math.pi) * progress, dtype=f32)
    return float(min_lr + (f32(base_lr) - min_lr) * cos / f32(2.0))


@dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.02
    batch_size: int = 32          # global batch (optimizer step granularity)
    micro_batch_size: int = 8     # per-step batch on the card
    num_epochs: int = 5
    warmup_fraction: float = 0.2  # of one epoch (== --wp)
    use_cosine: bool = False
    min_lr_ratio: float = 0.01
    max_input_length: int = 1024
    lm_head_chunk_size: int = 128
    log_interval: int = 100
    save_interval: int = 10000
    seed: int = 1337
    compute_dtype: str = "bfloat16"
    frozen_dtype: str = ""  # e.g. "bfloat16": store frozen base leaves low-p
    remat: bool | str = False  # False, True (whole blocks), "mlp" or "moe" (GPT.forward)
    mode: str = "lora"  # lora | adapter | adapter_v2 | full
    # AdamW's first-moment storage dtype ("" = the parameter's; "bfloat16"
    # rounds the stored moment each step, as optax's mu_dtype does)
    mu_dtype: str = ""
    pipeline_stages: int = 1       # >1: GPipe over the block stack
    pipeline_microbatches: int = 2  # microbatches in flight a step
    pipeline_data: int = 1         # data extent of the (data, pipe) mesh

    @property
    def grad_accum(self) -> int:
        assert self.batch_size % self.micro_batch_size == 0
        return self.batch_size // self.micro_batch_size


class AdamW(torch.optim.Optimizer):
    """AdamW in the arithmetic of optax's `adamw` (`scale_by_adam`, then
    `add_decayed_weights`, then the learning rate), per leaf in fp32:

        m = (1 - b1) g + b1 mu         (b1 mu in mu's dtype, as JAX's weak
                                        scalar; then fp32)
        v = (1 - b2) g^2 + b2 nu
        u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p
        p = p - lr u;  mu = m in `mu_dtype`;  nu = v

    so with mu_dtype bf16 the moment is updated in fp32 from the stored bf16
    one, the update uses the fp32 moment, and only the stored moment is
    rounded. `torch.optim.AdamW` has no mu_dtype. Each step runs as
    multi-tensor (`torch._foreach_*`) passes over the leaves, as torch's
    does: a loop of ops a leaf added 14 ms of small launches to the
    TinyLlama LoRA 8 x 1024 step on an H100. The state keeps torch's names
    (`step`, a CPU tensor; `exp_avg`; `exp_avg_sq`); param groups carry
    their own lr, as torch's do."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype=None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    def init_state(self, p) -> dict:
        state = self.state[p]
        state["step"] = torch.tensor(0.0)
        state["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
        state["exp_avg_sq"] = torch.zeros_like(p)
        return state

    # elements a multi-tensor pass takes at once: its temporaries (the new
    # moment, the denominator, the update, the decay term) stay near 1 GB
    # where mode full's 1.1 B fp32 masters at once would hold 17.6 GB
    CHUNK = 1 << 26

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            # the leaves of one step count, device and moment dtype update
            # together, a few multi-tensor launches a chunk
            batches = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p] or self.init_state(p)
                state["step"] += 1
                key = (state["step"].item(), p.device, state["exp_avg"].dtype)
                batches.setdefault(key, []).append((p, state))
            for (t, _, mu_dtype), leaves in batches.items():
                chunk, size = [], 0
                for p, state in leaves:
                    if chunk and size + p.numel() > self.CHUNK:
                        self._update(group, t, mu_dtype, chunk)
                        chunk, size = [], 0
                    chunk.append((p, state))
                    size += p.numel()
                self._update(group, t, mu_dtype, chunk)

    @staticmethod
    def _update(group, t: float, mu_dtype, leaves: list) -> None:
        """The update of `leaves` [(param, state)], all at step t."""
        f32 = np.float32
        b1, b2 = group["betas"]
        ps = [p for p, _ in leaves]
        states = [state for _, state in leaves]
        grads = [p.grad for p in ps]
        nus = [state["exp_avg_sq"] for state in states]
        # b1 mu in mu's dtype: b1 rounded to it first, as JAX's weak scalar is
        b1_mu = float(torch.tensor(b1, dtype=mu_dtype))
        m = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(m, [x.float() for x in torch._foreach_mul(
            [state["exp_avg"] for state in states], b1_mu)])
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        denom = torch._foreach_div(nus, float(f32(1) - f32(b2) ** f32(t)))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        u = torch._foreach_div(m, float(f32(1) - f32(b1) ** f32(t)))
        torch._foreach_div_(u, denom)
        del denom
        torch._foreach_add_(u, torch._foreach_mul(ps, group["weight_decay"]))
        torch._foreach_mul_(u, -float(f32(group["lr"])))
        torch._foreach_add_(ps, u)
        for state, x in zip(states, m):
            state["exp_avg"] = x.to(mu_dtype)


def make_optimizer(cfg: TrainConfig, params) -> AdamW:
    """AdamW, torch defaults (betas .9/.999, eps 1e-8), decay on every
    trainable leaf (ref: finetune/ger.py:132), the first moment in
    `cfg.mu_dtype`; the LR is set per step."""
    return AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=cfg.weight_decay,
                 mu_dtype=getattr(torch, cfg.mu_dtype) if cfg.mu_dtype else None)


class Trainer:
    """Drives optimizer steps over host batches on the model's device.

    params: a `GPT`, or a parameter tree in the JAX package's layout, which
    is loaded into a new `GPT` on `device` (None: the card, raising without
    one) in `compute_dtype`, its trainable leaves as fp32 masters of the
    tree's values.

    mesh: this rank's mesh; a tree then loads as the rank's pieces, and a
    `GPT` must have been built on the same mesh."""

    def __init__(self, model_cfg: GPTConfig, train_cfg: TrainConfig, params, *,
                 device=None, mesh=None, monitor=None, logger=None):
        if train_cfg.mu_dtype not in ("", "bfloat16", "float32"):
            raise ValueError(f"mu_dtype {train_cfg.mu_dtype!r}")
        dtype = getattr(torch, train_cfg.compute_dtype)
        if train_cfg.pipeline_stages > 1:
            assert mesh is None, (
                "pipeline_stages builds its own (data, pipe) mesh; "
                "fsdp/tensor/expert sharding does not compose with PP — "
                "drop those flags or use the non-PP sharded path"
            )
            if isinstance(params, GPT) and params.mesh is not None:
                mesh = params.mesh  # a stage built on its pipe mesh
            else:
                mesh = pipeline.make_pipe_mesh(train_cfg.pipeline_stages,
                                               data=max(train_cfg.pipeline_data, 1))
        self.mesh = mesh
        # the rank that writes files (all ranks gather what it writes)
        self.lead = mesh is None or not torch.distributed.is_initialized() or (
            torch.distributed.get_rank() == 0)
        tree = None
        if isinstance(params, GPT):
            model = params
            if model.mesh is not mesh:
                raise ValueError("the model was built on another mesh than the trainer's")
        else:
            tree = params
            model = params_from_jax(params, model_cfg, device=device, dtype=dtype, mesh=mesh)
        if model.dtype != dtype:
            raise ValueError(f"model computes in {model.dtype}, the config asks for "
                             f"{train_cfg.compute_dtype}")
        self.model = model
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.monitor = monitor  # SpeedMonitor: updated from train_step itself
        self.logger = logger  # StepLogger: CSV row every log_interval steps
        self.opt_step = 0
        self.micro_iter = 0  # the reference counts micro-iterations
        self._window_losses = []

        self.trainable = self._trainable_parameters()
        mastered = False
        for name, p in model.named_parameters():
            if name in self.trainable and p.dtype != torch.float32:
                # a trainable leaf is an fp32 master (mode "full": every weight)
                p.data = p.data.float()
                mastered = True
            p.requires_grad_(name in self.trainable)
            if train_cfg.frozen_dtype and name not in self.trainable and p.is_floating_point():
                # frozen leaves never update; store them at compute precision
                p.data = p.data.to(getattr(torch, train_cfg.frozen_dtype))
        if mastered and tree is not None:
            load_tree(model, tree)  # the masters take the tree's fp32 values
        self.optimizer = self._make_optimizer()

    def _trainable_parameters(self) -> dict:
        """The leaves that train, by parameter name (`GPT.trainable_parameters`
        of the mode)."""
        return self.model.trainable_parameters(self.cfg.mode)

    def _make_optimizer(self) -> torch.optim.Optimizer:
        return make_optimizer(self.cfg, list(self.trainable.values()))

    # ---- loss ----
    def _loss(self, ids, labels, *, train: bool, generator=None):
        hidden = self.model(ids, generator=generator,
                            remat=self.cfg.remat if train else False,
                            return_hidden=True)
        # shift: logits[t] predicts labels[t+1] (ref: finetune/ger.py:279-281)
        hidden = hidden[:, :-1]
        targets = labels[:, 1:]
        mean_all = train  # the reference's mean over all tokens in training
        lm_head = self.model.lm_head
        if lm_head.with_lora or lm_head.adapter_scale is not None:
            # a LoRA or adapter-v2 head needs the full head transform
            return cross_entropy(lm_head(hidden), targets, mean_all_tokens=mean_all)
        # validation uses the proper valid-token mean, chunk_size=0
        # (ref: finetune/ger.py:346)
        return chunked_cross_entropy(
            hidden, lm_head.weight, targets,
            chunk_size=self.cfg.lm_head_chunk_size if train else 0,
            lm_head_b=lm_head.bias, mean_all_tokens=mean_all)

    def _to_device(self, array):
        return torch.as_tensor(np.asarray(array), dtype=torch.long).to(self.model.device)

    # ---- the mesh ----
    def _pipelined(self) -> bool:
        return self.mesh is not None and "pipe" in self.mesh.shape

    def _batch_axes(self) -> tuple:
        """The axes the batch's rows split over."""
        return ("data",) if self._pipelined() else ("data", "fsdp")

    def _shard_batch(self, ids, labels):
        """This rank's part of host arrays (..., B, T): its rows of the
        batch axes (a pipeline's: its rows of each microbatch) and, where T
        divides, its tokens of `seq` (`_shard_batch` of the JAX package).
        The labels come back shifted (targets[t] = labels[t + 1], the last
        ignored), split alike. Returns (ids, targets, seq_split)."""
        ids, labels = np.asarray(ids), np.asarray(labels)
        targets = np.full_like(labels, IGNORE_INDEX)
        targets[..., :-1] = labels[..., 1:]
        mesh = self.mesh
        b, t = ids.shape[-2:]
        n = mesh.extent(*self._batch_axes())
        if self._pipelined():
            rows = pipeline.local_rows(b, self.cfg.pipeline_microbatches, n,
                                       mesh.index("data"))
        else:
            if b % n:
                raise ValueError(f"batch {b} does not split over data x fsdp = {n}")
            i = mesh.index(*self._batch_axes())
            rows = np.arange(i * (b // n), (i + 1) * (b // n))
        ids, targets = ids[..., rows, :], targets[..., rows, :]
        seq = mesh.shape.get("seq", 1)
        seq_split = seq > 1 and t % seq == 0
        if seq_split:
            j, tl = mesh.index("seq"), t // seq
            ids, targets = ids[..., j * tl:(j + 1) * tl], targets[..., j * tl:(j + 1) * tl]
        return ids, targets, seq_split

    def _loss_group(self):
        """The ranks whose losses add up to the step's (the rows' axes and
        seq)."""
        return self.mesh.group(*self._batch_axes(), "seq")

    def _mesh_nll(self, ids, targets, *, train: bool, generator=None):
        """(summed CE of this rank's tokens, its count of valid targets)."""
        model = self.model
        if self._pipelined():
            hidden = pipeline.pipeline_hidden(
                model, ids, self.mesh, n_micro=self.cfg.pipeline_microbatches,
                generator=generator if train else None, local=True)
        else:
            hidden = model(ids, generator=generator,
                           remat=self.cfg.remat if train else False, return_hidden=True)
        nll, mask = _token_ce(model.head_logits(hidden), targets)
        return nll.sum(), mask.sum()

    def _reduce_grads(self) -> None:
        """Sum each trainable leaf's gradient over the ranks that hold the
        same piece of it and saw other data: one flat all-reduce a group."""
        buckets = {}
        for name, p in self.trainable.items():
            spec = self.model.specs.get(name, ())
            axes = [a for a in self._batch_axes() if a not in spec] + ["seq"]
            group = self.mesh.group(*axes)
            if group is not None:
                buckets.setdefault(tuple(axes), (group, []))[1].append(p.grad)
        for group, grads in buckets.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            comm.all_reduce_(flat, group)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def _full(self, named: dict) -> dict:
        """{name: tensor} of the model's leaves as whole leaves (the
        rank's pieces gathered); a pipeline's stages contribute their own
        blocks. On the host."""
        if self.mesh is None:
            return named
        if self._pipelined():
            mine = {n: t.detach().cpu() for n, t in named.items()}
            whole = {}
            for part in comm.all_gather_objects(mine, self.mesh.group("pipe")):
                whole.update(part)
            return whole
        return {n: sharding.gather_leaf(t.detach(), self.model.specs[n], self.mesh).cpu()
                for n, t in named.items()}

    # ---- schedule ----
    def _lr(self, max_iters, warmup_steps) -> float:
        return lr_at_step(self.micro_iter, base_lr=self.cfg.learning_rate,
                          warmup_steps=warmup_steps, max_iters=max_iters,
                          use_cosine=self.cfg.use_cosine,
                          min_lr_ratio=self.cfg.min_lr_ratio)

    # ---- observability (wired into the step, not bolted on by callers) ----
    def _record_step(self, loss, lr: float, tokens: int, samples: int, seq_len: int):
        """loss is a device scalar, only materialised (a sync) at log
        intervals."""
        if self.monitor is not None:
            self.monitor.on_step(
                tokens=tokens, samples=samples,
                flops=tokens * estimate_train_flops_per_token(self.model_cfg, seq_len))
        if self.logger is not None:
            self._window_losses.append(loss)
            interval = max(self.cfg.log_interval // self.cfg.grad_accum, 1)
            if self.opt_step % interval == 0:
                avg = float(sum(self._window_losses)) / len(self._window_losses)
                self._window_losses.clear()
                stats = self.monitor.stats() if self.monitor is not None else {}
                self.logger.log(self.opt_step, loss=avg, lr=lr, **stats)

    # ---- public API ----
    def train_step(self, batch, max_iters, warmup_steps, generator=None):
        """One optimizer step over a superbatch dict from collate
        (batch['input_ids'] of shape (accum * micro, T)). generator: the
        LoRA dropout's (see `GPT.forward`); None means no dropout. Returns
        (mean micro-batch loss as a device scalar, lr). The averaged
        gradients stay in the leaves' `.grad` until the next step."""
        accum = self.cfg.grad_accum
        mb = self.cfg.micro_batch_size
        ids = np.asarray(batch["input_ids"]).reshape(accum, mb, -1)
        labels = np.asarray(batch["labels"]).reshape(accum, mb, -1)
        n_tokens, seq_len = ids.size, ids.shape[-1]
        self.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.model.device)
        if self.mesh is None:
            ids, labels = self._to_device(ids), self._to_device(labels)
            for i in range(accum):
                loss = self._loss(ids[i], labels[i], train=True, generator=generator)
                loss.backward()
                loss_sum += loss.detach()
        else:
            ids, targets, seq_split = self._shard_batch(ids, labels)
            ids, targets = self._to_device(ids), self._to_device(targets)
            # the reference's mean over every position of the global batch;
            # seq ranks that hold the same tokens share its sum
            denom = mb * (seq_len - 1) * (1 if seq_split else self.mesh.shape.get("seq", 1))
            for i in range(accum):
                nll, _ = self._mesh_nll(ids[i], targets[i], train=True, generator=generator)
                loss = nll / denom
                loss.backward()
                loss_sum += loss.detach()
            for p in self.trainable.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self._reduce_grads()
            comm.all_reduce_(loss_sum, self._loss_group())
        for p in self.trainable.values():
            # a leaf no loss reached (a gated-off layer) has a zero gradient,
            # and still decays, as in the JAX package
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.div_(accum)
        # advance the micro-iteration clock; the LR is the last micro step's,
        # as in the reference loop at optimizer.step time
        self.micro_iter += accum
        lr = self._lr(max_iters, warmup_steps)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.opt_step += 1
        loss = loss_sum / accum
        self._record_step(loss, lr, tokens=n_tokens, samples=accum * mb, seq_len=seq_len)
        return loss, lr

    def train_chunk(self, batches, max_iters, warmup_steps, generator=None):
        """N optimizer steps, as N `train_step` calls. Returns (losses (N,)
        device tensor, last lr)."""
        losses = []
        lr = None
        for batch in batches:
            loss, lr = self.train_step(batch, max_iters, warmup_steps, generator)
            losses.append(loss)
        return torch.stack(losses), lr

    @torch.no_grad()
    def evaluate(self, batches) -> float:
        """Mean validation loss, skipping all-masked batches
        (ref: finetune/ger.py:338-348); no dropout."""
        losses = []
        for batch in batches:
            targets = np.asarray(batch["labels"])[:, 1:]
            if (targets != IGNORE_INDEX).sum() == 0:
                continue
            if self.mesh is None:
                loss = self._loss(self._to_device(batch["input_ids"]),
                                  self._to_device(batch["labels"]), train=False)
            else:
                ids, targets, seq_split = self._shard_batch(batch["input_ids"],
                                                            batch["labels"])
                nll, count = self._mesh_nll(self._to_device(ids), self._to_device(targets),
                                            train=False)
                total = torch.stack([nll.float(), count.float()])
                if not seq_split:
                    total = total / self.mesh.shape.get("seq", 1)
                comm.all_reduce_(total, self._loss_group())
                loss = total[0] / total[1]
            losses.append(float(loss))
        return sum(losses) / max(len(losses), 1)

    @property
    def params(self) -> dict:
        """The model's parameter tree in the JAX package's layout (what
        `ckpt.io.save_params` writes); on a mesh the whole leaves, which
        every rank must ask for together."""
        if self.mesh is None:
            return tree_from_model(self.model)
        full = self._full(dict(self.model.named_parameters()))
        flat = flat_from_named(full, self.model_cfg.n_layer, device="cpu")
        return ckpt_io.unflatten({k: t if t.dtype == torch.bfloat16 else t.numpy()
                                  for k, t in flat.items()})

    @property
    def trainable_params(self) -> dict:
        """The trainable leaves alone, as a tree in the same layout (what
        the JAX package's `ckpt.io.save_adapter_only` writes): they load
        over the base weights as the full tree does (`load_tree` with
        strict=False; the JAX package's `_overlay`)."""
        return ckpt_io.unflatten({k: t.cpu().numpy()
                                  for k, t in self._flat(self.trainable).items()})

    # ---- exact-resume checkpointing ----
    def _flat(self, named: dict) -> dict:
        return flat_from_named(self._full(named), self.model_cfg.n_layer)

    def save_train_state(self, path, extra: dict | None = None) -> None:
        """Trainable leaves (under `trainable::`, in the JAX package's key
        layout), the AdamW moments and step, and the micro-iteration clock
        in one npz; `extra` stores small ints (e.g. the epoch index). On a
        mesh every rank calls it (the leaves are gathered) and rank 0
        writes."""
        sep = ckpt_io.SEP
        arrays = {f"trainable{sep}{k}": v for k, v in self._flat(self.trainable).items()}
        state = [self.optimizer.state.get(p) for p in self.trainable.values()]
        if all(state):
            for moment in ("exp_avg", "exp_avg_sq"):
                named = {n: s[moment] for n, s in zip(self.trainable, state)}
                arrays.update({f"optstate{sep}{moment}{sep}{k}": v
                               for k, v in self._flat(named).items()})
            arrays[f"optstate{sep}step"] = state[0]["step"]
        flat = ckpt_io.flatten(arrays)
        flat["meta_micro_iter"] = np.asarray(self.micro_iter)
        flat["meta_opt_step"] = np.asarray(self.opt_step)
        for k, v in (extra or {}).items():
            flat[f"extra_{k}"] = np.asarray(v)
        if not self.lead:
            return
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **flat)

    @torch.no_grad()
    def load_train_state(self, path) -> dict:
        """Restore a `save_train_state` checkpoint in place. Returns the
        `extra` dict."""
        sep = ckpt_io.SEP
        with np.load(Path(path)) as z:
            flat = {k: z[k] for k in z.files}
        self.micro_iter = int(flat.pop("meta_micro_iter"))
        self.opt_step = int(flat.pop("meta_opt_step"))
        extra = {k[len("extra_"):]: int(v) for k, v in flat.items()
                 if k.startswith("extra_")}

        def section(prefix):
            return self._named({k[len(prefix):]: v for k, v in flat.items()
                                if k.startswith(prefix)})

        for name, value in section(f"trainable{sep}").items():
            if name in self.trainable:
                self.trainable[name].copy_(self._local(name, value))
        self.optimizer.state.clear()
        if f"optstate{sep}step" in flat:
            step = float(flat[f"optstate{sep}step"])
            avg = section(f"optstate{sep}exp_avg{sep}")
            avg_sq = section(f"optstate{sep}exp_avg_sq{sep}")
            for name, p in self.trainable.items():
                state = self.optimizer.init_state(p)
                state["step"].fill_(step)
                state["exp_avg"].copy_(self._local(name, avg[name]))
                state["exp_avg_sq"].copy_(self._local(name, avg_sq[name]))
        return extra

    def _local(self, name: str, value):
        """This rank's piece of a whole leaf of parameter `name`."""
        if self.mesh is None:
            return value
        return sharding.local_piece(value, self.model.specs[name], self.mesh)

    def _named(self, flat: dict) -> dict:
        tensors = {}
        for key, value in flat.items():
            if key.endswith(ckpt_io.BF16_TAG):
                key, t = key[: -len(ckpt_io.BF16_TAG)], ckpt_io.bf16_from_bits(value)
            else:
                t = torch.from_numpy(np.ascontiguousarray(value))
            tensors[key] = t
        return named_from_flat(tensors, self.model_cfg.n_layer)
