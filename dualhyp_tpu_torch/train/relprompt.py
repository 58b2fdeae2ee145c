"""RelPrompt trainer: the LoRA LLM and the two reliability classifiers, with
two learning-rate groups.

Counterpart of `dualhyp_tpu/train/relprompt.py` (ref: finetune/relprompt.py):
  * two AdamW groups, "llm" (the LoRA leaves) at `learning_rate` and
    "classifier" (both `NoiseClassifier`s) at `classifier_learning_rate`,
    each on the warmup/cosine schedule in micro-iteration units
    (ref: :320-341), betas .9/.999, eps 1e-8 and the same weight decay on
    every trainable leaf: optax `multi_transform` over two unmasked
    `adamw`s;
  * loss = llm_loss + mask_loss_weight * (audio CE + visual CE) (ref:
    :389-403, weight 0.02); the audio classifier pools by 2 *
    classifier_pool_size (Whisper's 50 frames a second), the visual one by
    classifier_pool_size;
  * one step a batch (the JAX step takes its batch whole, no accumulation),
    the micro-iteration clock advanced by one;
  * validation reports the mask accuracy, precision, recall and F1 and the
    LLM loss, which alone selects the best model (ref: :559-595).

The config's PEFT leaves and the classifiers train (`gpt.trainable_mask`
of the JAX package, through `GPT.trainable_parameters`): LoRA, or the
adapter leaves under mode "adapter" / "adapter_v2"; `wte`, with the three
appended mask-token rows, stays one frozen leaf, stored in
`frozen_dtype`. The groups take no `mu_dtype`, as the JAX package's
two-group optimizer takes none. The encoder features (frozen Whisper /
BRAVEn) come precomputed in the batch ("audio_features",
"visual_features"). On the card the classifiers and their backward run in
fp32 with TF32 off (`device.exact_fp32`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dualhyp_tpu_torch.device import exact_fp32
from dualhyp_tpu_torch.models import relprompt
from dualhyp_tpu_torch.ops.cross_entropy import IGNORE_INDEX
from dualhyp_tpu_torch.train.trainer import AdamW, TrainConfig, Trainer, lr_at_step

CLASSIFIERS = ("audio_noise_classifier", "visual_noise_classifier")


@dataclass
class RelPromptTrainConfig(TrainConfig):
    classifier_learning_rate: float = 1e-4
    mask_loss_weight: float = 0.02
    mode: str = "lora"


def is_classifier(name: str) -> bool:
    return name.split(".", 1)[0] in CLASSIFIERS


class RelPromptTrainer(Trainer):
    """`Trainer` with the classifiers trainable, two optimizer groups and
    the mask loss. params: a RelPrompt `GPT` or a tree in the JAX
    package's layout (see `Trainer`)."""

    def _make_optimizer(self) -> torch.optim.Optimizer:
        """Two AdamW groups by parameter name (== two param_groups, ref:
        finetune/relprompt.py:174-195); the LRs are set per step."""
        cfg = self.cfg
        groups = [{"name": "llm", "lr": cfg.learning_rate,
                   "params": [p for n, p in self.trainable.items() if not is_classifier(n)]},
                  {"name": "classifier", "lr": cfg.classifier_learning_rate,
                   "params": [p for n, p in self.trainable.items() if is_classifier(n)]}]
        return AdamW(groups, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                     weight_decay=cfg.weight_decay)

    def _pools(self):
        pool = self.model_cfg.classifier_pool_size
        return {"audio": 2 * pool, "visual": pool}

    def _features(self, batch, key):
        return torch.as_tensor(np.asarray(batch[key], np.float32)).to(self.model.device)

    def _mask_loss(self, batch, generator=None):
        """audio CE + visual CE of the classifiers on the batch's features
        (dropout from `generator`; none without one)."""
        loss = 0.0
        for kind, pool in self._pools().items():
            logits = getattr(self.model, f"{kind}_noise_classifier")(
                self._features(batch, f"{kind}_features"), pool, generator=generator,
                dropout=self.model_cfg.classifier_dropout)
            loss = loss + relprompt.mask_loss(logits, self._to_device(
                batch[f"{kind}_mask_targets"]))
        return loss

    def _lrs(self, max_iters, warmup_steps):
        kw = dict(warmup_steps=warmup_steps, max_iters=max_iters,
                  use_cosine=self.cfg.use_cosine, min_lr_ratio=self.cfg.min_lr_ratio)
        return (lr_at_step(self.micro_iter, base_lr=self.cfg.learning_rate, **kw),
                lr_at_step(self.micro_iter, base_lr=self.cfg.classifier_learning_rate, **kw))

    def train_step(self, batch, max_iters, warmup_steps, generator=None,
                   classifier_generator=None):
        """One optimizer step over the whole batch (input_ids, labels, the
        features and the mask targets). generator: the LoRA dropout's (see
        `GPT.forward`); classifier_generator: the classifiers' dropout's;
        None means no dropout. Returns {"loss", "llm_loss", "mask_loss"
        (device scalars), "lr", "classifier_lr"}."""
        self.micro_iter += 1
        lr_llm, lr_cls = self._lrs(max_iters, warmup_steps)
        ids = self._to_device(batch["input_ids"])
        labels = self._to_device(batch["labels"])
        self.optimizer.zero_grad(set_to_none=True)
        llm = self._loss(ids, labels, train=True, generator=generator)
        mask = self._mask_loss(batch, classifier_generator)
        total = llm + self.cfg.mask_loss_weight * mask
        with exact_fp32():  # the classifiers' backward too
            total.backward()
        for p in self.trainable.values():
            if p.grad is None:  # a gated-off layer: a zero gradient, still decays
                p.grad = torch.zeros_like(p)
        for group, lr in zip(self.optimizer.param_groups, (lr_llm, lr_cls)):
            group["lr"] = lr
        self.optimizer.step()
        self.opt_step += 1
        total = total.detach()
        self._record_step(total, lr_llm, tokens=ids.numel(), samples=ids.shape[0],
                          seq_len=ids.shape[-1])
        return {"loss": total, "llm_loss": llm.detach(), "mask_loss": mask.detach(),
                "lr": lr_llm, "classifier_lr": lr_cls}

    @torch.no_grad()
    def validate(self, batches) -> dict:
        """The LLM loss (the selection key, ref: finetune/relprompt.py:594-
        595) and the mask metrics over the argmax of the classifiers'
        logits, trimmed to the targets' length; all-masked batches are
        skipped."""
        llm_losses, preds, targs = [], [], []
        for batch in batches:
            if (np.asarray(batch["labels"])[:, 1:] != IGNORE_INDEX).sum() == 0:
                continue
            llm_losses.append(float(self._loss(self._to_device(batch["input_ids"]),
                                               self._to_device(batch["labels"]),
                                               train=False)))
            for kind, pool in self._pools().items():
                logits = getattr(self.model, f"{kind}_noise_classifier")(
                    self._features(batch, f"{kind}_features"), pool)
                targets = np.asarray(batch[f"{kind}_mask_targets"])
                t = min(logits.shape[1], targets.shape[1])
                preds.append(logits[:, :t].argmax(-1).cpu().numpy().ravel())
                targs.append(targets[:, :t].ravel())
        metrics = relprompt.mask_metrics(
            np.concatenate(preds) if preds else np.zeros(0),
            np.concatenate(targs) if targs else np.zeros(0))
        metrics["llm_loss"] = sum(llm_losses) / max(len(llm_losses), 1)
        return metrics
