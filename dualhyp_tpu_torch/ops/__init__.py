"""Compute ops: each kernel's wrapper beside its plain PyTorch version.

A wrapper launches its hand-written CUDA kernel (`csrc/`, built by `_lib`)
for CUDA tensors and runs the plain version for CPU tensors; on the card
there is no fallback.
"""

from dualhyp_tpu_torch.ops.attention import FLASH_BWD, FLASH_FWD
from dualhyp_tpu_torch.ops.flash_fwd import FLASH_CAUSAL, FLASH_FULL
from dualhyp_tpu_torch.ops.gmm import (GROUPED_MATMUL, GROUPED_MATMUL_DLHS,
                                       GROUPED_MATMUL_DRHS)
from dualhyp_tpu_torch.ops.int4 import Q4_MATMUL
from dualhyp_tpu_torch.ops.lora import LORA_LINEAR
from dualhyp_tpu_torch.ops.rmsnorm import RMS_NORM
from dualhyp_tpu_torch.ops.rope import ROPE, ROPE_T
from dualhyp_tpu_torch.ops.splash import SPLASH_DKV, SPLASH_DQ, SPLASH_FWD
from dualhyp_tpu_torch.ops.swiglu import SWIGLU

# every hand-written kernel of the port, by the name of its wrapper
KERNELS = {
    "rms_norm": RMS_NORM,
    "apply_rope": ROPE,
    "flash_attention_fwd": FLASH_FWD,
    "flash_attention_bwd": FLASH_BWD,
    "swiglu_mlp": SWIGLU,
    "lora_linear": LORA_LINEAR,
    "q4_matmul": Q4_MATMUL,
    "full_attention_fwd": FLASH_FULL,
    "causal_attention_fwd": FLASH_CAUSAL,
    "grouped_matmul": GROUPED_MATMUL,
    "grouped_matmul_dlhs": GROUPED_MATMUL_DLHS,
    "grouped_matmul_drhs": GROUPED_MATMUL_DRHS,
    "splash_attention_fwd": SPLASH_FWD,
    "splash_attention_dq": SPLASH_DQ,
    "splash_attention_dkv": SPLASH_DKV,
}
# launches of a kernel above in its transposed direction (the backward),
# counted apart
TRANSPOSED = {"apply_rope": ROPE_T}
