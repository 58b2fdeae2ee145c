"""Where the port's entry points run.

They run on the card unless the caller names another device: with no
device named and no CUDA device present they raise, so a run never carries
on silently on the CPU. The CPU runs the plain PyTorch version of every
kernel and is what the tests name.
"""

from __future__ import annotations

import contextlib

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
