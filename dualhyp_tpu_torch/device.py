"""Where the port's entry points run.

They run on the card unless the caller names another device: with no
device named and no CUDA device present they raise, so a run never carries
on silently on the CPU. The CPU runs the plain PyTorch version of every
kernel and is what the tests name.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels"
            )
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def exact_fp32():
    """fp32 products and convolutions in full fp32 on the card for the
    duration: cuDNN runs an fp32 convolution in TF32 by default, and TF32
    keeps ~1e-3 where the Whisper encoder and the RelPrompt classifiers are
    held to ~1e-4. Restores both switches after, so the rest of the process
    keeps its own."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`; to the card from pinned memory without a
    host sync (the copy is ordered on the stream before its readers; a
    pageable copy would wait for the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
