"""LoRA finetuning (counterpart of `dualhyp_tpu/train`)."""

from dualhyp_tpu_torch.train.trainer import TrainConfig, Trainer, lr_at_step

__all__ = ["TrainConfig", "Trainer", "lr_at_step"]
