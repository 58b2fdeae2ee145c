"""From the JAX package's parameter tree to the port's `GPT`.

The tree is nested dicts of arrays: what `dualhyp_tpu.ckpt.io.load_params`
and this package's `ckpt.io.load_params` return, or `gpt.init` of the JAX
package after `np.asarray` on each leaf. Leaf `a/b/c` loads into parameter
`a.b.c`; leaves under `blocks` are stacked over layers and load slice `i`
into `blocks.i.*`. Matrices are cast to the model's compute dtype; norm
scales stay fp32, as the JAX ops read them.
"""

from __future__ import annotations

import numpy as np
import torch

from dualhyp_tpu_torch.ckpt.io import bf16_from_bits
from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.models.gpt import GPT


def _leaves(tree: dict, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    arr = np.array(value)
    if arr.dtype.name == "bfloat16":  # ml_dtypes, as JAX trees hold bf16
        return bf16_from_bits(arr.view(np.uint16))
    return torch.from_numpy(arr)


@torch.no_grad()
def load_tree(model: GPT, tree: dict, strict: bool = True) -> None:
    """Copy the tree's leaves into `model` in place.

    strict: every parameter of the model must be in the tree. A leaf the
    model has no parameter for always raises (a quantized or adapter leaf
    of a variant that is not ported)."""
    params = dict(model.named_parameters())
    seen = set()
    n_layer = model.cfg.n_layer
    for path, value in _leaves(tree):
        arr = _tensor(value)
        if path[0] == "blocks":
            if arr.shape[0] != n_layer:
                raise ValueError(f"{'/'.join(path)}: {arr.shape[0]} layers for {n_layer}")
            targets = [(f"blocks.{i}.{'.'.join(path[1:])}", arr[i]) for i in range(n_layer)]
        else:
            targets = [(".".join(path), arr)]
        for name, src in targets:
            if name not in params:
                raise KeyError(f"checkpoint leaf {'/'.join(path)} has no parameter {name}")
            dst = params[name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape mismatch at {name}: checkpoint "
                                 f"{tuple(src.shape)} vs model {tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))
            seen.add(name)
    missing = sorted(set(params) - seen)
    if strict and missing:
        raise KeyError(f"checkpoint lacks {len(missing)} parameters, e.g. {missing[:5]}")


def params_from_jax(tree: dict, cfg: GPTConfig, *, device=None,
                    dtype=torch.bfloat16) -> GPT:
    """A `GPT` holding the JAX parameter tree's values (every leaf needed)."""
    model = GPT(cfg, device=device, dtype=dtype)
    load_tree(model, tree, strict=True)
    return model
