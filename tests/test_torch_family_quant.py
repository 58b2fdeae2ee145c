"""The GPT-NeoX / Phi / Falcon family's quantized decoding and `merge_lora`
in the port against the JAX package, on the CPU (the configs and parameter
draws of test_torch_family.py, at width 256, the narrowest `quantize_tree`
quantizes, for the quantized logits).

Tolerances: quantized logits 1e-4, as `test_torch_quant.py` holds them
(both packages read the same int8 / int4 bytes; fp32 sums in another
order); the loaded leaves bit for bit; `merge_lora` 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.ops import quant as jquant
from dualhyp_tpu_torch.ckpt.convert import tree_from_model
from dualhyp_tpu_torch.models.gpt import merge_lora
from tests.test_torch_family import ATOL, FAMILY, WIDE, _model, _params, _prompts
from tests.test_torch_quant import _bits, _flat


@pytest.mark.parametrize("family", FAMILY)
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_logits_match_jax(family, mode):
    """The JAX package merges and quantizes (`quantize_tree` keeps the
    biases); the port loads the same bytes, biases beside them, and both
    prefill and take one decode step."""
    groups = 1 if family == "falcon" else WIDE["n_head"]
    cfg, params = _params(family, seed=2, **WIDE, n_query_groups=groups)
    params = jax.tree_util.tree_map(
        np.asarray, jquant.quantize_tree(jgpt.merge_lora(params, cfg), mode=mode))
    model = _model(cfg, params)
    round_trip = dict(_flat(tree_from_model(model)))
    for key, value in _flat(params):
        np.testing.assert_array_equal(_bits(round_trip[key]), _bits(value), err_msg=key)
    mlp = model.blocks[0].mlp
    assert mlp.fc.quant == mode and (mlp.fc.bias is not None) == cfg.bias
    ids, lengths = _prompts(9)
    jcache = jgpt.init_cache(cfg, 3, 16, dtype=jnp.float32)
    want, jcache = jgpt.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                jcache, compute_dtype=jnp.float32)
    cache = model.init_cache(3, 16)
    got = model.prefill(torch.from_numpy(ids).long(), torch.from_numpy(lengths).long(), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    token = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    want, _ = jgpt.decode_step(params, cfg, jnp.asarray(token), jnp.asarray(lengths),
                               jcache, compute_dtype=jnp.float32)
    got = model.decode_step(torch.from_numpy(token).long(), torch.from_numpy(lengths).long(),
                            cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("family", FAMILY)
def test_merge_lora_matches_jax_and_keeps_the_biases(family):
    cfg, params = _params(family, seed=3, lora_head=True)
    want = jax.tree_util.tree_map(np.asarray, jgpt.merge_lora(params, cfg))
    got = dict(_flat(tree_from_model(merge_lora(_model(cfg, params)))))
    assert sorted(got) == sorted(dict(_flat(want)))
    for key, value in _flat(want):
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5, err_msg=key)
