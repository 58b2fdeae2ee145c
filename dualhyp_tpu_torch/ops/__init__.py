"""Compute ops: each kernel's wrapper beside its plain PyTorch version.

A wrapper launches its hand-written CUDA kernel (`csrc/`, built by `_lib`)
for CUDA tensors and runs the plain version for CPU tensors; on the card
there is no fallback.
"""

from dualhyp_tpu_torch.ops.attention import FLASH_FWD
from dualhyp_tpu_torch.ops.rmsnorm import RMS_NORM
from dualhyp_tpu_torch.ops.rope import ROPE
from dualhyp_tpu_torch.ops.swiglu import SWIGLU

# every hand-written kernel of the port, by the name of its wrapper
KERNELS = {
    "rms_norm": RMS_NORM,
    "apply_rope": ROPE,
    "flash_attention_fwd": FLASH_FWD,
    "swiglu_mlp": SWIGLU,
}
