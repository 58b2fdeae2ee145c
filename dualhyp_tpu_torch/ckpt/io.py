"""npz checkpoints in the JAX package's format (`dualhyp_tpu/ckpt/io.py`).

  * one array per leaf of the parameter tree, keyed by its path joined by
    `::` (`blocks::attn::qkv::weight`);
  * per-layer tensors stacked on axis 0;
  * weights in torch's (out_features, in_features) layout;
  * a bf16 leaf stored as its uint16 bit pattern under a `@bf16` suffix.

`load_params` returns the nested dict of numpy arrays; bf16 leaves come back
as torch bf16 tensors, since numpy has no bfloat16. `save_params` writes
such a tree (numpy arrays or torch tensors as leaves), so the JAX package's
`load_params` reads what the port saves; `save_adapter_only` writes its
PEFT leaves alone and `load_adapter_over` lays such a file over a tree.

`load_safetensors` reads a HF `*.safetensors` file (the Whisper checkpoints)
without the `safetensors` package, which the card's machine does not have.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

SEP = "::"
BF16_TAG = "@bf16"


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """uint16 bit patterns -> a torch bfloat16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def bits_from_bf16(t: torch.Tensor) -> np.ndarray:
    """A torch bfloat16 tensor -> its uint16 bit patterns."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16)


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {`::`-joined key: numpy array}; a bf16 leaf becomes
    its bit pattern under key + `@bf16`."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{SEP}{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten(value, path))
        elif isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
            flat[path + BF16_TAG] = bits_from_bf16(value)
        elif isinstance(value, torch.Tensor):
            flat[path] = value.detach().cpu().numpy()
        else:
            flat[path] = np.asarray(value)
    return flat


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


def save_params(path, tree: dict) -> None:
    """Write a parameter tree as the JAX package's npz
    (`dualhyp_tpu/ckpt/io.py:save_params`)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flatten(tree))


def save_adapter_only(path, tree: dict, cfg) -> None:
    """Write the PEFT leaves of a parameter tree alone (`save_adapter_only`
    of the JAX package: its `adapter_only` keeps the leaves `trainable_mask`
    marks, `models.gpt.is_peft_leaf` here)."""
    from dualhyp_tpu_torch.models.gpt import is_peft_leaf

    flat = flatten(tree)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: v for k, v in flat.items()
                      if is_peft_leaf(k.replace(SEP, "/"), cfg)})


def load_adapter_over(tree: dict, path) -> dict:
    """A new tree: `tree` with the leaves of the npz at `path` over it
    (`load_adapter_over` of the JAX package: strict=False, a leaf the file
    lacks keeps its value, a key the tree lacks raises KeyError)."""
    flat = _untagged(flatten(tree))
    with np.load(Path(path)) as z:
        overlay = _untagged({k: z[k] for k in z.files})
    unknown = set(overlay) - set(flat)
    if unknown:
        raise KeyError(f"adapter checkpoint has unknown keys: {sorted(unknown)[:5]}")
    flat.update(overlay)
    return unflatten(flat)


def _untagged(flat: dict) -> dict:
    """{key: array} with each `@bf16` leaf as a bf16 tensor under its key."""
    out = {}
    for key, value in flat.items():
        if key.endswith(BF16_TAG):
            key, value = key[: -len(BF16_TAG)], bf16_from_bits(value)
        out[key] = value
    return out


# safetensors element types this reader takes, by their header name
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path) -> dict:
    """{name: tensor} of a `*.safetensors` file, read without the
    `safetensors` package: an 8-byte little-endian header length, a JSON
    header ({name: {dtype, shape, data_offsets}}, offsets into the data that
    follows it), then the raw little-endian tensors. The tensors are copies
    on the CPU in their stored dtype."""
    path = Path(path)
    with open(path, "rb") as fp:
        n_header = int.from_bytes(fp.read(8), "little")
        header = json.loads(fp.read(n_header))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n_header)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which "
                             "this reader does not take")
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        if begin == end:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.from_numpy(np.array(data[begin:end]))
        out[name] = raw.view(dtype).reshape(info["shape"])
    del data
    return out
