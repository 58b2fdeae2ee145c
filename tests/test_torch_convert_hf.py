"""The port's HF checkpoint conversion (LLaMA family) against the JAX
package's, on the CPU.

Synthetic HF-layout tensors drawn with numpy from a seed, for a
TinyLlama-shaped config and a 2-expert Mixtral-shaped one (`block_sparse_moe`
router and experts), go through both packages' `convert_llama_family` and
must give the same tree exactly (the same copies, concatenations and
stacks; no arithmetic). A directory of those tensors written as safetensors
loads through the port's `cli.common.load_model` into the same logits,
exactly, as the JAX conversion loaded by `params_from_jax` (the same fp32
weights through the same plain forward). The registry knows no tiny config,
so both packages' `config_from_name` are pointed at the test's config.
"""

import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from dualhyp_tpu.ckpt import convert_hf as jconvert_hf
from dualhyp_tpu.ckpt import io as jio
from dualhyp_tpu_torch.ckpt import convert_hf
from dualhyp_tpu_torch.ckpt.convert import params_from_jax
from dualhyp_tpu_torch.cli.common import load_model
from tests import helpers
from tests.test_torch_gpt import _port_config
from tests.test_torch_moe import _moe_cfg

CONFIGS = {"tinyllama": lambda: helpers.tiny_llama_config(name="tiny-llama-hf-test"),
           "mixtral": lambda: _moe_cfg(name="tiny-mixtral-hf-test", n_expert=2)}


def _hf_tensors(cfg, seed, vocab=90, tied=False):
    """HF-layout fp32 tensors of `cfg`: `vocab` embedding rows (fewer than
    the padded vocabulary, so the rows pad), lm_head tied to the embedding
    when `tied`."""
    rng = np.random.default_rng(seed)
    d, hs, inter = cfg.n_embd, cfg.head_size, cfg.intermediate_size

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32)

    hf = {"model.embed_tokens.weight": w(vocab, d), "model.norm.weight": w(d)}
    if not tied:
        hf["lm_head.weight"] = w(vocab, d)
    for i in range(cfg.n_layer):
        p = f"model.layers.{i}."
        hf[p + "self_attn.q_proj.weight"] = w(cfg.n_head * hs, d)
        hf[p + "self_attn.k_proj.weight"] = w(cfg.n_query_groups * hs, d)
        hf[p + "self_attn.v_proj.weight"] = w(cfg.n_query_groups * hs, d)
        hf[p + "self_attn.o_proj.weight"] = w(d, cfg.n_head * hs)
        hf[p + "input_layernorm.weight"] = w(d)
        hf[p + "post_attention_layernorm.weight"] = w(d)
        if cfg.mlp_class == "LLaMAMoE":
            hf[p + "block_sparse_moe.gate.weight"] = w(cfg.n_expert, d)
            for x in range(cfg.n_expert):
                e = f"{p}block_sparse_moe.experts.{x}."
                hf[e + "w1.weight"], hf[e + "w3.weight"] = w(inter, d), w(inter, d)
                hf[e + "w2.weight"] = w(d, inter)
        else:
            hf[p + "mlp.gate_proj.weight"] = w(inter, d)
            hf[p + "mlp.up_proj.weight"] = w(inter, d)
            hf[p + "mlp.down_proj.weight"] = w(d, inter)
    return hf


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_convert_llama_family_matches_jax_exactly(model, dtype, tied):
    cfg = CONFIGS[model]()
    hf = _hf_tensors(cfg, seed=1, tied=tied)
    if dtype == "bfloat16":
        jax_hf = {k: v.astype(ml_dtypes.bfloat16) for k, v in hf.items()}
        port_hf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in hf.items()}
    else:
        jax_hf, port_hf = hf, {k: torch.from_numpy(v) for k, v in hf.items()}
    want = jconvert_hf.convert_llama_family(jax_hf, cfg)
    got = convert_hf.convert_llama_family(port_hf, _port_config(cfg))
    want_flat = {k: np.asarray(v).astype(np.float32) for k, v in _leaves(want)}
    got_flat = {k: v.float().numpy() for k, v in _leaves(got)}
    assert sorted(got_flat) == sorted(want_flat)
    for key, value in want_flat.items():
        np.testing.assert_array_equal(got_flat[key], value, err_msg=key)
    assert all(v.dtype == getattr(torch, dtype) for _, v in _leaves(got))
    assert got["wte"]["weight"].shape[0] == cfg.padded_vocab_size


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}::{key}" if prefix else key
        if isinstance(value, dict):
            yield from _leaves(value, path)
        else:
            yield path, value


@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_interleave_and_split_qkv_match_jax_and_round_trip(rng, model):
    cfg = CONFIGS[model]()
    hs, hq, g = cfg.head_size, cfg.n_head, cfg.n_query_groups
    q = rng.normal(size=(hq * hs, cfg.n_embd)).astype(np.float32)
    k, v = (rng.normal(size=(g * hs, cfg.n_embd)).astype(np.float32) for _ in range(2))
    want = jconvert_hf.interleave_qkv(q, k, v, cfg)
    got = convert_hf.interleave_qkv(*(torch.from_numpy(x) for x in (q, k, v)),
                                    _port_config(cfg))
    np.testing.assert_array_equal(got.numpy(), want)
    for x, w, orig in zip(convert_hf.split_qkv(got, _port_config(cfg)),
                          jconvert_hf.split_qkv(want, cfg), (q, k, v)):
        np.testing.assert_array_equal(x.numpy(), w)
        np.testing.assert_array_equal(x.numpy(), orig)


@pytest.fixture
def hf_dir(tmp_path, monkeypatch):
    """A factory: an HF-layout safetensors directory (two shards) of a
    config, with both packages' registry lookups pointed at it."""

    def make(cfg, seed):
        monkeypatch.setattr(jconvert_hf, "config_from_name", lambda name: cfg)
        monkeypatch.setattr(convert_hf, "config_from_name", lambda name: _port_config(cfg))
        path = tmp_path / cfg.name
        path.mkdir()
        hf = _hf_tensors(cfg, seed)
        keys = sorted(hf)
        save_file({k: hf[k] for k in keys[::2]}, str(path / "model-00001-of-00002.safetensors"))
        save_file({k: hf[k] for k in keys[1::2]}, str(path / "model-00002-of-00002.safetensors"))
        return path

    return make


@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_load_model_reads_an_hf_directory(hf_dir, model):
    """The port's `load_model` on the directory gives the logits of the JAX
    conversion loaded by `params_from_jax`, exactly."""
    cfg = CONFIGS[model]()
    path = hf_dir(cfg, seed=2)
    tree = jconvert_hf.convert_hf_checkpoint(path, cfg.name)
    want_model = params_from_jax(tree, _port_config(cfg), device="cpu", dtype=torch.float32)
    got_model = load_model(path, _port_config(cfg), device="cpu", seed=0, dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(3).integers(1, 90, size=(2, 12)))
    with torch.no_grad():
        assert torch.equal(got_model(ids), want_model(ids))


def test_convert_cli_writes_what_the_jax_converter_writes(hf_dir, tmp_path):
    """`convert_hf_checkpoint(..., out_path, dtype="bfloat16")`, what the
    module's `__main__` runs: the same npz leaves (bf16 bit patterns) and
    the same `dualhyp_config.json` as the JAX package's."""
    cfg = CONFIGS["tinyllama"]()
    path = hf_dir(cfg, seed=4)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jconvert_hf.convert_hf_checkpoint(path, cfg.name, tmp_path / "jax" / "m.npz", "bfloat16")
    convert_hf.convert_hf_checkpoint(path, cfg.name, tmp_path / "port" / "m.npz", "bfloat16")
    with np.load(tmp_path / "jax" / "m.npz") as want, np.load(tmp_path / "port" / "m.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        assert all(key.endswith("@bf16") for key in got.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    read = [json.loads((tmp_path / side / "dualhyp_config.json").read_text())
            for side in ("jax", "port")]
    assert read[0] == read[1]
    # the JAX package reads the port's file into its own tree's bf16 values
    loaded = jio.load_params(tmp_path / "port" / "m.npz")
    assert jnp.asarray(loaded["blocks"]["attn"]["qkv"]["weight"]).dtype == jnp.bfloat16


@pytest.mark.parametrize("family,key", [
    ("GPT-NeoX", "gpt_neox.layers.0.attention.query_key_value.weight"),
    ("Falcon", "transformer.h.0.self_attention.query_key_value.weight"),
    ("Phi", "model.layers.0.self_attn.dense.weight")])
def test_other_families_raise(tmp_path, family, key):
    """A directory holding one tensor of the NeoX, Falcon or Phi layout goes
    to that family's converter (ported since; converted in full by
    test_torch_family_convert_hf.py), which raises for the tensors it
    lacks, naming one of its own family's keys."""
    save_file({key: np.zeros((4, 4), np.float32)}, str(tmp_path / "model.safetensors"))
    prefix = {"GPT-NeoX": "gpt_neox.", "Falcon": "transformer.h.", "Phi": "model."}[family]
    with pytest.raises(KeyError, match=prefix):
        convert_hf.convert_hf_checkpoint(tmp_path, "tiny-llama-1.1b-chat")
