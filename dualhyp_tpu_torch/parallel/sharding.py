"""Sharding rules for the parameter tree and the batch.

Counterpart of `dualhyp_tpu/parallel/sharding.py`, on the checkpoint tree
(`ckpt/io`: nested dicts, per-layer leaves stacked on axis 0, weights in
(out, in) layout). A spec is a tuple with one entry a dim: None
(replicated), an axis name, or a tuple of axis names; it is what
`jax.sharding.PartitionSpec` holds, entry for entry. The rules are the JAX
package's, exactly (`_leaf_spec`):

  * an MoE expert stack (L, E, out, in) shards E over `expert` where it
    divides;
  * `attn/qkv`, `fc_1`, `fc_2`, `mlp/fc/` and `lm_head` leaves shard their
    out dim over `tensor` (column parallel); `proj/weight*` leaves their in
    dim (row parallel);
  * the largest remaining dim shards over `fsdp` where it divides; a 1-D
    leaf (past the layer axis) of width >= 1024 shards over `fsdp`.

`shard_params` returns this rank's pieces of each leaf, as `device_put`
places them on the device at the rank's mesh coordinates.

The model's own layout (`model_spec`) is the spec but for one thing: the
LoRA leaves (`lora_A`, `lora_B`) are kept whole over `tensor`, where the
rule shards their first dim (the rank dim of an A of a column-parallel
linear, or a B's rows). A rank applies the slice of B (column parallel) or
of A (row parallel) that meets its piece of the weight and the gradient is
summed over the tensor ranks (`comm.copy_to`), so the numbers are the
JAX package's; a rank dim of r = 4 under tensor 8 would not divide at all.
"""

from __future__ import annotations

import numpy as np

from dualhyp_tpu_torch.parallel import comm
from dualhyp_tpu_torch.parallel.mesh import Mesh

TENSOR_COLUMN = ("attn/qkv", "fc_1", "fc_2", "mlp/fc/", "lm_head")
LORA_LEAVES = ("lora_A", "lora_B")


def replicated(mesh: Mesh) -> tuple:
    return ()


def batch_sharding(mesh: Mesh) -> tuple:
    """The batch dim shards over data x fsdp (fsdp ranks consume data too)."""
    return (("data", "fsdp"),)


def _leaf_spec(path: str, leaf, fsdp: int, tensor: int, expert: int = 1) -> tuple:
    shape = tuple(np.shape(leaf)) if not hasattr(leaf, "shape") else tuple(leaf.shape)
    ndim = len(shape)
    stacked = path.startswith("blocks/")
    # dims eligible for sharding exclude the stacked layer axis
    first = 1 if stacked else 0
    spec = [None] * ndim
    # MoE expert stacks (L, E, out, in): the expert axis over `expert`
    moe_expert = (ndim - first == 3
                  and any(k in path for k in ("mlp/fc_1", "mlp/fc_2", "mlp/proj")))
    if moe_expert:
        if expert > 1 and shape[first] % expert == 0:
            spec[first] = "expert"
        first += 1  # out/in dims follow the expert axis
    is_tensor_col = tensor > 1 and any(k in path for k in TENSOR_COLUMN)
    is_tensor_row = tensor > 1 and ("proj/weight" in path)
    if ndim - first >= 2:
        out_dim, in_dim = first, first + 1  # torch layout (out, in)
        if is_tensor_col:
            spec[out_dim] = "tensor"
        elif is_tensor_row:
            spec[in_dim] = "tensor"
        if fsdp > 1:
            # the largest remaining dim over fsdp
            cand = [d for d in range(first, ndim) if spec[d] is None]
            if cand:
                d = max(cand, key=lambda i: shape[i])
                if shape[d] % fsdp == 0:
                    spec[d] = "fsdp"
    elif ndim - first == 1 and fsdp > 1 and shape[-1] % fsdp == 0 and shape[-1] >= 1024:
        spec[-1] = "fsdp"
    return tuple(spec)


def leaves(tree: dict, prefix: str = ""):
    """(path joined by "/", leaf) of a nested dict, depth first."""
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            yield from leaves(value, path)
        else:
            yield path, value


def _map(tree: dict, fn, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        out[key] = _map(value, fn, path) if isinstance(value, dict) else fn(path, value)
    return out


def param_shardings(params: dict, mesh: Mesh) -> dict:
    """The spec of every leaf of the tree, the same tree shape."""
    fsdp, tensor, expert = (mesh.shape.get(a, 1) for a in ("fsdp", "tensor", "expert"))
    return _map(params, lambda path, leaf: _leaf_spec(path, leaf, fsdp, tensor, expert))


def model_spec(path: str, shape, mesh: Mesh) -> tuple:
    """The layout the port's model keeps leaf `path` in: the JAX spec with
    the LoRA leaves whole over `tensor` (module docstring)."""
    fsdp, tensor, expert = (mesh.shape.get(a, 1) for a in ("fsdp", "tensor", "expert"))
    spec = _leaf_spec(path, _Shape(shape), fsdp, tensor, expert)
    if path.rsplit("/", 1)[-1] in LORA_LEAVES:
        spec = tuple(None if s == "tensor" else s for s in spec)
    return spec


class _Shape:
    """A stand-in leaf that has only a shape (meta-device and spec checks)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def piece_bounds(shape, spec, mesh: Mesh) -> list:
    """(start, stop) of this rank's piece on each dim of a leaf of `shape`
    laid out by `spec`."""
    bounds = []
    for dim, extent in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        if entry is None:
            bounds.append((0, extent))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = mesh.extent(*axes)
        if extent % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {axes} ({n})")
        step = extent // n
        i = mesh.index(*axes)
        bounds.append((i * step, (i + 1) * step))
    return bounds


def local_piece(leaf, spec, mesh: Mesh):
    """This rank's piece of a leaf (numpy array or tensor) under `spec`."""
    index = tuple(slice(a, b) for a, b in piece_bounds(tuple(leaf.shape), spec, mesh))
    return leaf[index]


def shard_params(params: dict, mesh: Mesh):
    """(this rank's pieces of every leaf, the specs): `shard_params` of the
    JAX package, as the shards `device_put` lays on this rank's device."""
    specs = param_shardings(params, mesh)
    flat_specs = dict(leaves(specs))
    pieces = _map(params, lambda path, leaf: local_piece(leaf, flat_specs[path], mesh))
    return pieces, specs


def gather_leaf(t, spec, mesh: Mesh):
    """The whole leaf from this rank's piece `t` laid out by `spec` (every
    rank of each sharding axis's group must call it); no gradient."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        group = mesh.group(*axes)
        if group is not None:
            t = comm._all_gather(t, dim, group)
    return t
