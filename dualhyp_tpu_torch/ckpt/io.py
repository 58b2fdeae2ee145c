"""npz checkpoints in the JAX package's format (`dualhyp_tpu/ckpt/io.py`).

  * one array per leaf of the parameter tree, keyed by its path joined by
    `::` (`blocks::attn::qkv::weight`);
  * per-layer tensors stacked on axis 0;
  * weights in torch's (out_features, in_features) layout;
  * a bf16 leaf stored as its uint16 bit pattern under a `@bf16` suffix.

`load_params` returns the nested dict of numpy arrays; bf16 leaves come back
as torch bf16 tensors, since numpy has no bfloat16.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

SEP = "::"
BF16_TAG = "@bf16"


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """uint16 bit patterns -> a torch bfloat16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        if key.endswith(BF16_TAG):
            key, value = key[: -len(BF16_TAG)], bf16_from_bits(value)
        node = tree
        parts = key.split(SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def load_params(path) -> dict:
    path = Path(path)
    with np.load(path if path.suffix == ".npz" else path.with_suffix(".npz")) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten(flat)
