"""LoRA and RelPrompt finetuning (counterpart of `dualhyp_tpu/train`)."""

from dualhyp_tpu_torch.train.relprompt import RelPromptTrainConfig, RelPromptTrainer
from dualhyp_tpu_torch.train.trainer import TrainConfig, Trainer, lr_at_step

__all__ = ["RelPromptTrainConfig", "RelPromptTrainer", "TrainConfig", "Trainer",
           "lr_at_step"]
