"""Run monitoring and logging (copies of the JAX package's `utils`)."""

from dualhyp_tpu_torch.utils.logging import StepLogger, setup_run_logger
from dualhyp_tpu_torch.utils.monitor import SpeedMonitor, estimate_train_flops_per_token

__all__ = ["SpeedMonitor", "StepLogger", "estimate_train_flops_per_token",
           "setup_run_logger"]
