"""From the JAX package's parameter tree to the port's `GPT`.

The tree is nested dicts of arrays: what `dualhyp_tpu.ckpt.io.load_params`
and this package's `ckpt.io.load_params` return, or `gpt.init` of the JAX
package after `np.asarray` on each leaf. Leaf `a/b/c` loads into parameter
`a.b.c`; leaves under `blocks` are stacked over layers and load slice `i`
into `blocks.i.*`. Each leaf is cast to its parameter's dtype: frozen
matrices to the model's compute dtype, LoRA leaves and norm scales to fp32.

A tree after `quantize_tree` (of either package) loads too: where it holds
`weight_q8`/`weight_scale` or `weight_q4`/`weight_scale4` in place of a
linear's `weight`, that linear of the model takes the quantized leaves
(int8 codes or packed bytes and fp32 scales, copied as they are), beside
the zeroed LoRA leaves a merge leaves behind.

An MoE tree (`mlp_class="LLaMAMoE"`) loads as it is: its router
`blocks/mlp/gate/weight` (L, E, d) and expert stacks `blocks/mlp/{fc_1,
fc_2,proj}/weight` (L, E, out, in) into each block's `MoE` stacks. A
quantized MoE tree does not: the port, like the JAX package, runs the
expert stacks' float weights only.

A RelPrompt tree loads into a RelPrompt `GPT` (`use_relprompt`,
`n_extra_tokens`): its `audio_noise_classifier` and `visual_noise_classifier`
leaves into the model's two classifiers, its `wte` with the extra rows.

`tree_from_model` is the inverse: the model's parameters as such a tree.
`encoder_from_jax` and `decoder_from_jax` take the JAX package's Whisper
encoder and decoder trees to the port's (`models/whisper`), which are the
same trees as torch tensors; `raven_from_jax` (also named
`espnet_decoder_from_jax`, `espnet_lm_from_jax` and `avsr_from_jax`) does
the same for the VSR/AVSR trees, keeping each leaf's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from dualhyp_tpu_torch.ckpt.io import SEP, bf16_from_bits, unflatten
from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.device import resolve_device
from dualhyp_tpu_torch.models.gpt import GPT
from dualhyp_tpu_torch.ops import quant
from dualhyp_tpu_torch.parallel import sharding


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


def _module_names(path: tuple, n_layer: int) -> list:
    """The model's module names for the tree node at `path`."""
    if path[0] == "blocks":
        return [f"blocks.{i}.{'.'.join(path[1:])}" for i in range(n_layer)]
    return [".".join(path)]


def _quantize_like(model: GPT, tree: dict) -> None:
    """Give each linear whose tree node holds quantized leaves the same
    quantized parameters (empty, to be copied into). A node that is no
    linear of the model is left to `load_tree`, which raises for it."""
    modules = dict(model.named_modules())
    for path, _ in _leaves(tree):
        key = path[-1]
        if key not in (quant.Q_KEY, quant.Q4_KEY):
            continue
        node = tree
        for part in path[:-1]:
            node = node[part]
        scale_key = quant.SCALE_KEY if key == quant.Q_KEY else quant.SCALE4_KEY
        if scale_key not in node:
            continue
        stacked = path[0] == "blocks"
        shapes = {k: tuple(np.shape(node[k]))[int(stacked):] for k in (key, scale_key)}
        mode = "int8" if key == quant.Q_KEY else "int4"
        for name in _module_names(path[:-1], model.cfg.n_layer):
            mod = modules.get(name)
            if not hasattr(mod, "set_quantized") or mod.quant == mode:
                continue
            if mod.quant is not None:
                raise ValueError(f"{name} is quantized {mod.quant}, the checkpoint {mode}")
            device = mod.weight.device
            mod.set_quantized({
                key: torch.empty(shapes[key], dtype=torch.int8, device=device),
                scale_key: torch.empty(shapes[scale_key], dtype=torch.float32,
                                       device=device)})


@torch.no_grad()
def load_tree(model: GPT, tree: dict, strict: bool = True) -> None:
    """Copy the tree's leaves into `model` in place.

    strict: every parameter of the model must be in the tree. A leaf the
    model has no parameter for always raises (an adapter leaf of a variant
    that is not ported). A model on a mesh (`GPT(mesh=)`) takes the rank's
    pieces of the whole leaves (`parallel.sharding.model_spec`); a pipeline
    stage its own layers."""
    mesh = model.mesh
    if mesh is not None and "pipe" not in mesh.shape:
        tree = sharding._map(tree, lambda path, leaf: sharding.local_piece(
            _tensor(leaf), sharding.model_spec(path, np.shape(leaf), mesh), mesh))
    _quantize_like(model, tree)
    params = dict(model.named_parameters())
    seen = set()
    n_layer = model.cfg.n_layer
    for path, value in _leaves(tree):
        arr = _tensor(value)
        if path[0] == "blocks":
            if arr.shape[0] != n_layer:
                raise ValueError(f"{'/'.join(path)}: {arr.shape[0]} layers for {n_layer}")
            targets = [(f"blocks.{i}.{'.'.join(path[1:])}", arr[i]) for i in model.layer_range]
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
                    dtype=torch.bfloat16, mesh=None) -> GPT:
    """A `GPT` holding the JAX parameter tree's values (every leaf needed);
    on a mesh, the rank's pieces of them."""
    model = GPT(cfg, device=device, dtype=dtype, mesh=mesh)
    load_tree(model, tree, strict=True)
    return model


def flat_from_named(named: dict, n_layer: int, device=None) -> dict:
    """{parameter name: tensor} -> {`::`-joined tree key: tensor}: the
    tensors of `blocks.i.*` stacked over the layers on axis 0, as the JAX
    package keeps them. device: where the stacks are made (None: where the
    tensors are); tensors are moved there one leaf at a time."""
    flat, per_layer = {}, {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            per_layer.setdefault(SEP.join(parts[2:]), [None] * n_layer)[int(parts[1])] = t
        else:
            flat[SEP.join(parts)] = t.detach().to(device or t.device)
    for rest, layers in per_layer.items():
        flat[f"blocks{SEP}{rest}"] = torch.stack([t.detach().to(device or t.device)
                                                  for t in layers])
    return flat


def named_from_flat(flat: dict, n_layer: int) -> dict:
    """The inverse of `flat_from_named`: stacked leaves are split per layer."""
    named = {}
    for key, t in flat.items():
        parts = key.split(SEP)
        if parts[0] == "blocks":
            for i in range(n_layer):
                named[".".join(["blocks", str(i), *parts[1:]])] = t[i]
        else:
            named[".".join(parts)] = t
    return named


def encoder_from_jax(tree: dict, *, device=None, dtype=torch.float32) -> dict:
    """The JAX package's Whisper encoder tree (numpy or JAX arrays, as
    `init_encoder` or `convert_hf_whisper_encoder` give it, or tensors) as
    the port's encoder parameters: the same nested dict, each leaf a tensor
    on `device` (the card when None) in `dtype`."""
    device = resolve_device(device)
    return {key: encoder_from_jax(value, device=device, dtype=dtype)
            if isinstance(value, dict) else _tensor(value).to(device, dtype)
            for key, value in tree.items()}


def decoder_from_jax(tree: dict, *, device=None, dtype=torch.float32) -> dict:
    """The JAX package's Whisper decoder tree (`init_decoder`,
    `convert_hf_whisper_decoder`, or either after `quantize_tree`; numpy or
    JAX arrays, or tensors) as the port's decoder parameters on `device`
    (the card when None): float leaves in `dtype`, the quantized leaves
    (int8 codes or packed int4 bytes, fp32 scales) as they are, and the
    LayerNorm leaves (`*ln`) in fp32, the dtype LayerNorm computes in."""
    device = resolve_device(device)
    keep = {quant.Q_KEY, quant.SCALE_KEY, quant.Q4_KEY, quant.SCALE4_KEY}

    def walk(node, name=""):
        return {key: walk(value, key) if isinstance(value, dict)
                else _tensor(value).to(device) if key in keep
                else _tensor(value).to(device, torch.float32 if name.endswith("ln") else dtype)
                for key, value in node.items()}

    return walk(tree)


@torch.no_grad()
def tree_from_model(model: GPT) -> dict:
    """The model's parameters as the JAX package's tree, the inverse of
    `load_tree`: nested dicts, per-layer leaves stacked on axis 0, numpy
    arrays on the host (a bf16 leaf stays a torch bf16 tensor, as
    `ckpt.io.load_params` returns it). The stacks are made on the host, so
    the card never holds a second copy of the weights (a Mixtral expert
    stack of 16 layers is 15 GB)."""
    flat = flat_from_named(dict(model.named_parameters()), model.cfg.n_layer, device="cpu")
    return unflatten({key: t if t.dtype == torch.bfloat16 else t.numpy()
                      for key, t in flat.items()})


def raven_from_jax(tree: dict, *, device=None, dtype=None) -> dict:
    """A JAX package tree of the VSR/AVSR models (`models/raven`,
    `espnet_decoder`, `espnet_lm`, `avsr`: numpy or JAX arrays, or tensors,
    as `ckpt.io.load_params` of either package returns them) as the port's:
    the same nested dict, each leaf a tensor on `device` (the card when
    None), in `dtype`, or in its own dtype when None (a bf16 tree stays
    bf16, so `raven.encode_dtype` selects bf16 compute as in JAX)."""
    device = resolve_device(device)

    def leaf(value):
        t = _tensor(value)
        return t.to(device, dtype) if dtype is not None and t.is_floating_point() else t.to(device)

    return {key: raven_from_jax(value, device=device, dtype=dtype)
            if isinstance(value, dict) else leaf(value) for key, value in tree.items()}


espnet_decoder_from_jax = espnet_lm_from_jax = avsr_from_jax = raven_from_jax
