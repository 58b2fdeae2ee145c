"""dualhyp_tpu_torch: the PyTorch and CUDA port of dualhyp_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays as the reference: the same
module names, PyTorch idiom inside, and a hand-written Hopper kernel
(`csrc/`) for each TPU kernel on the ported path. Imports no JAX and nothing
of `dualhyp_tpu`.
"""

from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.registry import available_configs, config_from_name

__version__ = "0.1.0"

__all__ = ["GPTConfig", "config_from_name", "available_configs", "__version__"]
