"""The port's HF checkpoint conversion of the GPT-NeoX, Falcon and Phi
families against the JAX package's, on the CPU.

Synthetic HF-layout fp32 tensors drawn with numpy from a seed, for tiny
configs of each layout (GPT-NeoX as Pythia ships it; Falcon 7b-style, MQA
with one shared `input_layernorm`, and 40b-style, grouped with `ln_attn`
and `ln_mlp`; Phi with separate biased q/k/v, `dense`, `fc1`/`fc2` and a
biased head), go through both packages' converters and must give the same
tree exactly (copies, concatenations and stacks; no arithmetic). A
directory of those tensors written as safetensors loads through the port's
`cli.common.load_model` into the same logits, exactly, as the JAX
conversion loaded by `params_from_jax`. The registry knows no tiny config,
so both packages' `config_from_name` are pointed at the test's config.
"""

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from dualhyp_tpu.ckpt import convert_hf as jconvert_hf
from dualhyp_tpu_torch.ckpt import convert_hf
from dualhyp_tpu_torch.ckpt.convert import params_from_jax
from dualhyp_tpu_torch import registry
from dualhyp_tpu_torch.cli.common import load_model
from tests import helpers
from tests.test_torch_convert_hf import _leaves
from tests.test_torch_gpt import _port_config

# (config, the family's converter); a Falcon name with "7b" takes the
# shared-norm layout in the JAX converter, a shared_attention_norm config
# in the port's
CONFIGS = {
    "neox": (lambda: helpers.tiny_config(name="tiny-neox-hf-test"), "neox"),
    "falcon_7b": (lambda: helpers.tiny_config(
        name="tiny-falcon-7b-hf-test", n_query_groups=1, shared_attention_norm=True,
        bias=False), "falcon"),
    "falcon_40b": (lambda: helpers.tiny_config(
        name="tiny-falcon-40b-hf-test", n_query_groups=2, bias=False), "falcon"),
    "phi": (lambda: helpers.tiny_config(
        name="tiny-phi-hf-test", shared_attention_norm=True, gelu_approximate="tanh",
        lm_head_bias=True, rotary_percentage=0.5), "phi"),
}


def _hf_tensors(cfg, family, seed, vocab=90):
    """HF-layout fp32 tensors of `cfg` in the family's names, with `vocab`
    embedding rows (fewer than the padded vocabulary, so the rows pad)."""
    rng = np.random.default_rng(seed)
    d, hs, inter = cfg.n_embd, cfg.head_size, cfg.intermediate_size
    qkv = (cfg.n_head + 2 * cfg.n_query_groups) * hs

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def norm(prefix):
        return {f"{prefix}.weight": w(d), f"{prefix}.bias": w(d)}

    hf = {}
    if family == "neox":
        hf.update({"gpt_neox.embed_in.weight": w(vocab, d), "embed_out.weight": w(vocab, d),
                   **norm("gpt_neox.final_layer_norm")})
        for i in range(cfg.n_layer):
            p = f"gpt_neox.layers.{i}."
            hf.update({**norm(p + "input_layernorm"), **norm(p + "post_attention_layernorm")})
            for name, shape in (("attention.query_key_value", (qkv, d)),
                                ("attention.dense", (d, d)),
                                ("mlp.dense_h_to_4h", (inter, d)),
                                ("mlp.dense_4h_to_h", (d, inter))):
                hf[p + name + ".weight"], hf[p + name + ".bias"] = w(*shape), w(shape[0])
    elif family == "falcon":
        hf.update({"transformer.word_embeddings.weight": w(vocab, d),
                   "lm_head.weight": w(vocab, d), **norm("transformer.ln_f")})
        for i in range(cfg.n_layer):
            p = f"transformer.h.{i}."
            if cfg.shared_attention_norm:
                hf.update(norm(p + "input_layernorm"))
            else:
                hf.update({**norm(p + "ln_attn"), **norm(p + "ln_mlp")})
            hf[p + "self_attention.query_key_value.weight"] = w(qkv, d)
            hf[p + "self_attention.dense.weight"] = w(d, d)
            hf[p + "mlp.dense_h_to_4h.weight"] = w(inter, d)
            hf[p + "mlp.dense_4h_to_h.weight"] = w(d, inter)
    else:
        hf.update({"model.embed_tokens.weight": w(vocab, d), "lm_head.weight": w(vocab, d),
                   "lm_head.bias": w(vocab), **norm("model.final_layernorm")})
        for i in range(cfg.n_layer):
            p = f"model.layers.{i}."
            hf.update(norm(p + "input_layernorm"))
            for name, out_f, in_f in (("self_attn.q_proj", cfg.n_head * hs, d),
                                      ("self_attn.k_proj", cfg.n_query_groups * hs, d),
                                      ("self_attn.v_proj", cfg.n_query_groups * hs, d),
                                      ("self_attn.dense", d, d), ("mlp.fc1", inter, d),
                                      ("mlp.fc2", d, inter)):
                hf[p + name + ".weight"], hf[p + name + ".bias"] = w(out_f, in_f), w(out_f)
    return hf


def _convert(module, family, hf, cfg):
    if family == "falcon" and module is jconvert_hf:
        return module.convert_falcon_family(hf, cfg, cfg.name)
    return getattr(module, f"convert_{family}_family")(hf, cfg)


@pytest.mark.parametrize("name", [n for n in registry.available_configs() if "falcon" in n])
def test_falcon_layout_follows_the_config_as_the_jax_name_rule(name):
    """The port picks a Falcon's norm layout from shared_attention_norm; for
    every registry Falcon that is the layout the JAX converter picks by a
    "7b" in the name."""
    assert registry.config_from_name(name).shared_attention_norm == ("7b" in name)


@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_family_converters_match_jax_exactly(model):
    make, family = CONFIGS[model]
    cfg = make()
    hf = _hf_tensors(cfg, family, seed=1)
    want = _convert(jconvert_hf, family, hf, cfg)
    got = _convert(convert_hf, family, {k: torch.from_numpy(v) for k, v in hf.items()},
                   _port_config(cfg))
    want_flat = {k: np.asarray(v) for k, v in _leaves(want)}
    got_flat = {k: v.numpy() for k, v in _leaves(got)}
    assert sorted(got_flat) == sorted(want_flat)
    for key, value in want_flat.items():
        np.testing.assert_array_equal(got_flat[key], value, err_msg=key)
    assert ("blocks::norm_2::bias" in got_flat) == (not cfg.shared_attention_norm)


@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_load_model_reads_a_family_hf_directory(tmp_path, monkeypatch, model):
    """`load_model` on a two-shard safetensors directory (the dispatch of
    `convert_hf_checkpoint` by key layout) gives the logits of the JAX
    conversion loaded by `params_from_jax`, exactly."""
    make, family = CONFIGS[model]
    cfg = make()
    monkeypatch.setattr(jconvert_hf, "config_from_name", lambda name: cfg)
    monkeypatch.setattr(convert_hf, "config_from_name", lambda name: _port_config(cfg))
    path = tmp_path / cfg.name
    path.mkdir()
    hf = _hf_tensors(cfg, family, seed=2)
    keys = sorted(hf)
    save_file({k: hf[k] for k in keys[::2]}, str(path / "model-00001-of-00002.safetensors"))
    save_file({k: hf[k] for k in keys[1::2]}, str(path / "model-00002-of-00002.safetensors"))
    tree = jconvert_hf.convert_hf_checkpoint(path, cfg.name)
    want_model = params_from_jax(tree, _port_config(cfg), device="cpu", dtype=torch.float32)
    got_model = load_model(path, _port_config(cfg), device="cpu", seed=0, dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(3).integers(1, 90, size=(2, 12)))
    with torch.no_grad():
        assert torch.equal(got_model(ids), want_model(ids))
