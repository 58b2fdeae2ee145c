"""The PEFT families in the port against the JAX package, on the CPU:
LLaMA-Adapter v1 (the prefix attention), v2 (the scale and bias on every
linear) and LoRA on the MLP, in the LLaMA and the GPT-NeoX families.

Tiny fp32 configs of two layers (`tests/helpers`): TinyLlama-shaped (GQA,
RMSNorm, SwiGLU) and pythia-shaped (LayerNorm, the GPT-NeoX MLP, parallel
residual), with biases and without. The JAX init zeroes the gates, sets
the v2 scales to 1 and lora_B to 0, which would hide each family behind an
identity, so every PEFT leaf, bias and norm leaf is drawn from numpy
(`_randomise`). The adapter starts at layer 1 and the LoRA at layer 1 too,
so one layer runs gated off.

Tolerances: logits 1e-5 of the largest logit (fp32 sums in another order
over two layers); weights and saved adapter leaves exactly. Decoding is in
test_torch_peft_decode.py, verify steps and `merge_lora` in
test_torch_peft_verify.py, quantized decoding in test_torch_peft_quant.py,
training in test_torch_peft_train*.py and test_torch_peft_cli.py (each
file stays under 40 s in one process).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.ckpt import io as jio
from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu_torch import registry
from dualhyp_tpu_torch.ckpt import io
from dualhyp_tpu_torch.ckpt.convert import params_from_jax, tree_from_model
from dualhyp_tpu_torch.models.gpt import GPT, check_supported
from tests import helpers
from tests.test_torch_gpt import _port_config
from tests.test_torch_quant import _flat

REL = 1e-5
LORA = dict(lora_r=4, lora_alpha=8, lora_query=True, lora_key=True, lora_value=True,
            lora_projection=True, lora_start_layer=1)
# the PEFT families, each as the CLI's --mode builds its config, and all at once
CASES = {
    "adapter": dict(use_adapter=True, adapter_start_layer=1),
    "adapter_v2": dict(use_adapter=True, use_adapter_v2=True, adapter_start_layer=1),
    "lora_mlp": dict(LORA, lora_mlp=True),
    # LoRA (the head's too) under the v2 wrap: the wrap comes after the delta
    "lora_and_v2": dict(LORA, lora_mlp=True, lora_head=True, use_adapter=True,
                        use_adapter_v2=True, adapter_start_layer=1),
}
FAMILIES = {
    "llama": helpers.tiny_llama_config,
    "llama_bias": lambda **kw: helpers.tiny_llama_config(bias=True, **kw),
    "neox": helpers.tiny_config,
    "neox_no_bias": lambda **kw: helpers.tiny_config(bias=False, **kw),
}


def _randomise(tree, rng, path=()):
    """Every bias, norm leaf, lora_B and adapter leaf drawn from rng, so that
    none of them is an identity."""
    for key, value in tree.items():
        if isinstance(value, dict):
            _randomise(value, rng, path + (key,))
            continue
        if key == "scale" or key == "adapter_scale":
            centre, std = 1.0, 0.2
        elif key in ("bias", "adapter_bias", "lora_B", "gating_factor"):
            centre, std = 0.0, 0.5 if key == "gating_factor" else 0.2
        else:
            continue
        tree[key] = (centre + rng.normal(size=np.shape(value)) * std).astype(np.float32)


def _params(case, family="llama", seed=0, **kw):
    cfg = FAMILIES[family](**{**CASES[case], **kw})
    params = jax.tree_util.tree_map(np.asarray, jgpt.init(cfg, jax.random.key(seed)))
    _randomise(params, np.random.default_rng(seed))
    return cfg, params


def _model(cfg, params):
    return params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)


def _prompts(seed=7, vocab=90):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(3, 12)).astype(np.int32)
    lengths = np.array([12, 7, 9], np.int32)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids, lengths


def _close(got, want, rel=REL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _tensors(*arrays):
    return [torch.from_numpy(np.asarray(a)).long() for a in arrays]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("case", CASES)
def test_forward_logits_match_jax(case, family):
    cfg, params = _params(case, family)
    model = _model(cfg, params)
    ids, _ = _prompts()
    want = jgpt.forward(params, cfg, jnp.asarray(ids), compute_dtype=jnp.float32)
    got = model(torch.from_numpy(ids).long())
    _close(got.detach().numpy(), want)


@pytest.mark.parametrize("case", CASES)
def test_the_peft_leaves_count(case):
    """Each family moves the logits: the same tree with its PEFT leaves at
    their identities (zero gates and lora_B, unit scales, zero v2 biases)
    gives other logits, so the comparison above checks them."""
    cfg, params = _params(case)
    ids, _ = _prompts()
    got = _model(cfg, params)(torch.from_numpy(ids).long()).detach()
    neutral = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (np.ones_like(leaf) if path[-1].key == "adapter_scale" else
                            np.zeros_like(leaf) if path[-1].key in (
                                "lora_B", "gating_factor", "adapter_bias") else leaf), params)
    base = _model(cfg, neutral)(torch.from_numpy(ids).long()).detach()
    assert float((got - base).abs().max()) > 1e-2


@pytest.mark.parametrize("case", CASES)
def test_weights_round_trip_exactly(case):
    """`params_from_jax` then `tree_from_model` give back every leaf, the
    adapter leaves among them, bit for bit."""
    cfg, params = _params(case, "neox", seed=6)
    got = dict(_flat(tree_from_model(_model(cfg, params))))
    want = dict(_flat(params))
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("variant", [dict(use_adapter=True),
                                     dict(use_adapter=True, use_adapter_v2=True),
                                     dict(lora_r=16, lora_mlp=True)])
def test_check_supported_accepts_every_registry_config_with_peft(variant):
    for name in registry.available_configs():
        check_supported(registry.config_from_name(name, **variant))


def test_fused_lora_mlp_and_v2_keep_the_composition_on_the_cpu():
    """lora_impl "fused" (K5's plain version on the CPU) on the MLP's
    linears, under the v2 wrap: the logits within K5's rounding of the
    composition's (exact in fp32), and K4 bypassed as in the JAX package."""
    cfg, params = _params("lora_and_v2", seed=7)
    ids, _ = _prompts()
    want = _model(cfg, params)(torch.from_numpy(ids).long()).detach()
    fused = GPT(_port_config(cfg), device="cpu", dtype=torch.float32, lora_impl="fused")
    fused.load_state_dict(_model(cfg, params).state_dict())
    assert fused.blocks[0].mlp.fc_1.use_fused()
    got = fused(torch.from_numpy(ids).long()).detach()
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("config", ["adapter", "adapter_v2", "lora_and_v2"])
def test_adapter_checkpoints_round_trip(config, tmp_path):
    """`ckpt.io.save_adapter_only` writes the leaves the JAX package's does
    (the same keys and values); `load_adapter_over` lays them over another
    tree as the JAX one does, and raises for a key the tree lacks."""
    cfg, params = _params(config, seed=12)
    tree = tree_from_model(_model(cfg, params))
    io.save_adapter_only(tmp_path / "port.npz", tree, cfg)
    jio.save_adapter_only(tmp_path / "jax.npz", jax.tree_util.tree_map(jnp.asarray, params),
                          cfg)
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    _, base = _params(config, seed=13)
    got = io.load_adapter_over(base, tmp_path / "port.npz")
    want = jio.load_adapter_over(jax.tree_util.tree_map(jnp.asarray, base),
                                 tmp_path / "port.npz")
    got = dict(_flat(got))
    for key, value in _flat(want):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=key)
    np.savez(tmp_path / "stray.npz", **{"blocks::attn::nope": np.zeros(3)})
    with pytest.raises(KeyError, match="unknown keys"):
        io.load_adapter_over(base, tmp_path / "stray.npz")
