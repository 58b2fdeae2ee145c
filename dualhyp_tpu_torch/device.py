"""Where the port's entry points run.

They run on the card unless the caller names another device: with no
device named and no CUDA device present they raise, so a run never carries
on silently on the CPU. The CPU runs the plain PyTorch version of every
kernel and is what the tests name.
"""

from __future__ import annotations

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
