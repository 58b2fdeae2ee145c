"""The GPT-NeoX / Phi / Falcon family in the port against the JAX package, on
the CPU.

Three tiny fp32 configs, 2 layers of width 64 (256, the narrowest that
`quantize_tree` quantizes, for the quantized logits), LayerNorm with
biases, the GPT-NeoX MLP, parallel residual and partial rotary, with LoRA
r=4 on q/k/v/proj:

  * "pythia": `tests/helpers.tiny_config`'s shape (pythia-14m's): biases on
    every linear, a separate `norm_2`, exact gelu, rotary 0.25;
  * "phi": phi-2's: one shared norm, tanh gelu, a biased head, rotary 0.5;
  * "falcon": falcon-7b's: MQA (one KV group), one shared norm, no bias.

The JAX init zeroes biases, sets norms to 1 and lora_B to 0, so the tests
draw every bias, norm leaf and lora_B from numpy: otherwise none of them is
checked. Tolerances: logits, caches and attention 1e-4 (fp32 sums in
another order over a few layers; the plain K1 against the Pallas kernel in
interpret mode at T = 128); greedy tokens and weights exactly. Quantized
decoding and `merge_lora` are in test_torch_family_quant.py, LoRA training
in test_torch_family_train.py (each file stays under 40 s in one process).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.infer.decode import generate as jax_generate
from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.ops.pallas import flash_vjp
from dualhyp_tpu_torch import registry
from dualhyp_tpu_torch.ckpt.convert import params_from_jax, tree_from_model
from dualhyp_tpu_torch.infer.decode import generate
from dualhyp_tpu_torch.models.gpt import GPT, check_supported
from dualhyp_tpu_torch.ops import attention
from tests import helpers
from tests.test_torch_gpt import LORA, _port_config
from tests.test_torch_quant import _flat

ATOL = 1e-4

SHAPE = dict(n_embd=64, n_head=4, vocab_size=384, padding_multiple=128, block_size=64)
FAMILY = {
    "pythia": dict(SHAPE, n_query_groups=4),
    "phi": dict(SHAPE, n_query_groups=4, shared_attention_norm=True, gelu_approximate="tanh",
                lm_head_bias=True, rotary_percentage=0.5),
    "falcon": dict(SHAPE, n_query_groups=1, shared_attention_norm=True, bias=False),
}
# the narrowest width `quantize_tree` quantizes
WIDE = dict(n_embd=256, n_head=8)


def _randomise(tree, rng, path=()):
    """Every bias, norm scale and lora_B leaf of the tree drawn from rng."""
    for key, value in tree.items():
        if isinstance(value, dict):
            _randomise(value, rng, path + (key,))
        elif key == "bias" or key == "lora_B" or (key == "scale" and "norm" in path[-1] + "ln_f"):
            centre = 1.0 if key == "scale" else 0.0
            tree[key] = (centre + rng.normal(size=np.shape(value)) * 0.2).astype(np.float32)


def _params(family, seed=0, **kw):
    cfg = helpers.tiny_config(**{**FAMILY[family], **LORA, **kw})
    params = jax.tree_util.tree_map(np.asarray, jgpt.init(cfg, jax.random.key(seed)))
    _randomise(params, np.random.default_rng(seed))
    return cfg, params


def _model(cfg, params):
    return params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)


def _prompts(seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 380, size=(3, 12)).astype(np.int32)
    lengths = np.array([12, 7, 9], np.int32)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids, lengths


def test_registry_head_sizes_all_have_a_kernel_instance():
    """Every head size of the registry is one K1 and L1 take (32, 64, 80,
    96, 100, 128, 256 today), so a new config cannot slip past."""
    from dualhyp_tpu_torch.ops import splash

    sizes = {registry.config_from_name(n).head_size for n in registry.available_configs()}
    assert sizes == {32, 64, 80, 96, 100, 128, 256}
    assert sizes <= set(attention.FLASH_HEAD_SIZES) == set(splash.HEAD_SIZES)
    for d in sizes:  # every row the kernels read is a whole number of 16 bytes
        assert attention.padded_head_size(d) % 8 == 0


# (head size, query heads, KV groups): each new head size, and a group of 7
@pytest.mark.parametrize("d,hq,g", [(32, 2, 1), (80, 2, 1), (96, 2, 1), (100, 2, 1),
                                    (256, 2, 1), (80, 7, 1)])
def test_plain_k1_matches_jax_at_registry_head_sizes(d, hq, g):
    """K1's plain forward (O, L) and backward against `flash_vjp`: its
    Pallas forward and backward kernels in interpret mode at T = 128."""
    rng = np.random.default_rng(d + hq)
    q, do = (rng.normal(size=(1, hq, 128, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(1, g, 128, d)).astype(np.float32) for _ in range(2))
    scale = d ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: flash_vjp.flash_attention(a, b, c, scale),
                       *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    _, res = flash_vjp._forward(*(jnp.asarray(x) for x in (q, k, v)), scale)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = attention.causal_attention_plain_lse(*t[:3], scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4])[..., 0], rtol=0, atol=ATOL)
    got = attention.flash_attention_bwd_plain(*t[:3], o, lse, t[3], scale)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=ATOL)


@pytest.mark.parametrize("family", FAMILY)
def test_forward_prefill_and_decode_match_jax(family):
    """`GPT.forward` logits, then prefill and one decode step: logits and
    the K/V caches."""
    cfg, params = _params(family)
    model = _model(cfg, params)
    ids, lengths = _prompts()
    want = jgpt.forward(params, cfg, jnp.asarray(ids), compute_dtype=jnp.float32)
    got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)

    b, max_seq = ids.shape[0], 16
    jcache = jgpt.init_cache(cfg, b, max_seq, dtype=jnp.float32)
    want, jcache = jgpt.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                jcache, compute_dtype=jnp.float32)
    cache = model.init_cache(b, max_seq)
    got = model.prefill(torch.from_numpy(ids).long(), torch.from_numpy(lengths).long(), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    token = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    want, jcache = jgpt.decode_step(params, cfg, jnp.asarray(token), jnp.asarray(lengths),
                                    jcache, compute_dtype=jnp.float32)
    got = model.decode_step(torch.from_numpy(token).long(), torch.from_numpy(lengths).long(),
                            cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for i, name in enumerate(("k", "v")):
        stacked = torch.stack([layer[i] for layer in cache]).numpy()
        np.testing.assert_allclose(stacked, np.asarray(jcache[name]), rtol=0, atol=ATOL)


@pytest.mark.parametrize("family", FAMILY)
def test_greedy_tokens_match_jax(family):
    cfg, params = _params(family, seed=1)
    model = _model(cfg, params)
    ids, lengths = _prompts(8)
    want_toks, want_lens = jax_generate(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                        max_new_tokens=6, top_k=1, compute_dtype=jnp.float32)
    got_toks, got_lens = generate(model, torch.from_numpy(ids), torch.from_numpy(lengths),
                                  max_new_tokens=6, top_k=1)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))


@pytest.mark.parametrize("family", FAMILY)
def test_weights_round_trip_exactly(family):
    """`params_from_jax` then `tree_from_model` give back every leaf, the
    biases, LayerNorm biases and the `fc` leaves among them, bit for bit."""
    cfg, params = _params(family, seed=4, lora_head=True)
    got = dict(_flat(tree_from_model(_model(cfg, params))))
    want = dict(_flat(params))
    assert sorted(got) == sorted(want)
    new = [k for k in want if k.endswith("bias") or "/fc/" in k]
    assert new and all(np.array_equal(got[k], want[k]) for k in want)


def test_check_supported_takes_the_registry_and_refuses_peft_breadth():
    """Every registry config is accepted (the 46 LayerNorm / GPT-NeoX / bias
    configs among them). Adapters and LoRA on the MLP, refused until their
    slice was ported, are accepted now (test_torch_peft.py holds them to the
    JAX package). A quantized MoE is refused by `quantize_model`
    (test_torch_moe.py)."""
    names = registry.available_configs()
    family = [n for n in names
              if (lambda c: c.norm_class == "LayerNorm" or c.mlp_class == "GptNeoxMLP"
                  or c.bias)(registry.config_from_name(n))]
    assert len(family) == 46
    for name in names:
        check_supported(registry.config_from_name(name))
    for kw in (dict(use_adapter=True), dict(use_adapter_v2=True),
               dict(lora_r=4, lora_mlp=True)):
        check_supported(registry.config_from_name("phi-2", **kw))
    model = GPT(_port_config(helpers.tiny_config(use_adapter_v2=True)), device="cpu")
    assert model.lm_head.adapter_scale.shape == (model.cfg.padded_vocab_size,)
