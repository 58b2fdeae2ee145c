"""The port's GPT against the JAX package's, on the same parameter tree.

A tiny TinyLlama-shaped config (GQA, RMSNorm, SwiGLU, full rotary) with LoRA
on the fused QKV projection and on `proj`. `lora_B` is zero at init, so the
tests fill it with random values: otherwise the LoRA branch is not checked.
Everything runs in fp32 on the CPU, where the port runs the plain version of
each kernel; tolerance atol 1e-4 on logits and caches (fp32 sums in another
order, over a few layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.ckpt.io import save_params
from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu_torch.ckpt.convert import load_tree, params_from_jax
from dualhyp_tpu_torch.ckpt.io import load_params
from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.models.gpt import GPT
from tests import helpers

ATOL = 1e-4

LORA = dict(lora_r=4, lora_alpha=8, lora_query=True, lora_key=True,
            lora_value=True, lora_projection=True)

CASES = {
    "qkv_proj": dict(LORA),
    "start_layer_1": dict(LORA, lora_start_layer=1),
    # not all of q/k/v: the delta is scattered into the fused output rows
    "q_and_v": dict(LORA, lora_key=False),
    "partial_rotary": dict(LORA, rotary_percentage=0.5),
}


def _jax_params(cfg, seed=0):
    params = jgpt.init(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    attn = params["blocks"]["attn"]
    for leaf in (attn["qkv"], attn["proj"]):
        leaf["lora_B"] = jnp.asarray(
            rng.normal(size=leaf["lora_B"].shape).astype(np.float32) * 0.2)
    return jax.tree_util.tree_map(np.asarray, params)


def _port_config(cfg):
    return GPTConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _pair(case):
    cfg = helpers.tiny_llama_config(**CASES[case])
    params = _jax_params(cfg)
    model = params_from_jax(params, _port_config(cfg), device="cpu",
                            dtype=torch.float32)
    return cfg, params, model


def _prompts():
    rng = np.random.default_rng(7)
    ids = rng.integers(3, 90, size=(3, 12)).astype(np.int32)
    lengths = np.array([12, 7, 9], np.int32)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids, lengths


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case):
    cfg, params, model = _pair(case)
    ids, _ = _prompts()
    want = jgpt.forward(params, cfg, jnp.asarray(ids), compute_dtype=jnp.float32)
    got = model(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_step_match_jax(case):
    cfg, params, model = _pair(case)
    ids, lengths = _prompts()
    b, max_seq = ids.shape[0], 16

    jcache = jgpt.init_cache(cfg, b, max_seq, dtype=jnp.float32)
    want, jcache = jgpt.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                jcache, compute_dtype=jnp.float32)
    cache = model.init_cache(b, max_seq)
    got = model.prefill(torch.from_numpy(ids).long(), torch.from_numpy(lengths).long(),
                        cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for i, name in enumerate(("k", "v")):
        stacked = torch.stack([layer[i] for layer in cache]).numpy()
        np.testing.assert_allclose(stacked, np.asarray(jcache[name]), rtol=0, atol=ATOL)

    token = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    want, jcache = jgpt.decode_step(params, cfg, jnp.asarray(token), jnp.asarray(lengths),
                                    jcache, compute_dtype=jnp.float32)
    got = model.decode_step(torch.from_numpy(token).long(),
                            torch.from_numpy(lengths).long(), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for i, name in enumerate(("k", "v")):
        stacked = torch.stack([layer[i] for layer in cache]).numpy()
        np.testing.assert_allclose(stacked, np.asarray(jcache[name]), rtol=0, atol=ATOL)


def test_decode_step_leaves_inactive_rows_cache_alone():
    _, _, model = _pair("qkv_proj")
    ids, lengths = _prompts()
    cache = model.init_cache(3, 16)
    model.prefill(torch.from_numpy(ids).long(), torch.from_numpy(lengths).long(), cache)
    before = [[t.clone() for t in layer] for layer in cache]
    active = torch.tensor([True, False, True])
    model.decode_step(torch.tensor([4, 5, 6]), torch.from_numpy(lengths).long(), cache,
                      active=active)
    for layer, old in zip(cache, before):
        for new_t, old_t in zip(layer, old):
            assert torch.equal(new_t[1], old_t[1])
            assert not torch.equal(new_t[0], old_t[0])


def test_npz_checkpoint_round_trip(tmp_path):
    cfg = helpers.tiny_llama_config(**CASES["qkv_proj"])
    params = _jax_params(cfg)
    # one leaf in bf16: stored as its uint16 bits under `@bf16`
    params["wte"]["weight"] = np.asarray(jnp.asarray(params["wte"]["weight"], jnp.bfloat16))
    save_params(tmp_path / "model.npz", params)

    loaded = load_params(tmp_path / "model.npz")
    wte = loaded["wte"]["weight"]
    assert isinstance(wte, torch.Tensor) and wte.dtype == torch.bfloat16
    np.testing.assert_array_equal(wte.float().numpy(),
                                  params["wte"]["weight"].astype(np.float32))
    np.testing.assert_array_equal(loaded["blocks"]["attn"]["qkv"]["lora_B"],
                                  params["blocks"]["attn"]["qkv"]["lora_B"])

    model = params_from_jax(loaded, _port_config(cfg), device="cpu", dtype=torch.float32)
    ids, _ = _prompts()
    want = jgpt.forward(params, cfg, jnp.asarray(ids), compute_dtype=jnp.float32)
    np.testing.assert_allclose(model(torch.from_numpy(ids).long()).numpy(),
                               np.asarray(want), rtol=0, atol=ATOL)


def test_load_tree_rejects_unknown_and_missing_leaves():
    cfg = helpers.tiny_llama_config(**CASES["qkv_proj"])
    params = _jax_params(cfg)
    model = GPT(_port_config(cfg), device="cpu", dtype=torch.float32)
    with pytest.raises(KeyError, match="lacks"):
        load_tree(model, {"wte": params["wte"]}, strict=True)
    load_tree(model, {"wte": params["wte"]}, strict=False)
    with pytest.raises(KeyError, match="no parameter"):
        load_tree(model, {"wte": {"weight_q8": params["wte"]["weight"]}}, strict=False)


def test_unported_configs_raise():
    """A norm or MLP class the port does not know raises. Adapters and LoRA
    on the MLP are ported (PEFT breadth, test_torch_peft.py): their configs
    build, with the adapter leaves and the MLP's LoRA leaves."""
    with pytest.raises(NotImplementedError, match="mlp_class=NoSuchMLP"):
        GPT(_port_config(helpers.tiny_config(mlp_class="NoSuchMLP")), device="cpu")
    model = GPT(_port_config(helpers.tiny_config(use_adapter=True, use_adapter_v2=True)),
                device="cpu")
    assert model.blocks[0].attn.adapter_wte is not None
    assert model.blocks[0].mlp.fc.adapter_scale is not None
    model = GPT(_port_config(helpers.tiny_llama_config(lora_r=4, lora_mlp=True)),
                device="cpu")
    assert model.blocks[0].mlp.fc_1.with_lora
