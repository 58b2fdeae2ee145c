"""Adapter v1, v2 and LoRA-on-the-MLP speculative verify steps and
`merge_lora` in the port against the JAX package, on the CPU (the draws of
test_torch_peft.py): a verify step of 5 tokens a row after prefill, with a
float and an int8 KV cache (logits 1e-5 of the largest, greedy tokens
exactly); the merged weights, the MLP's among them (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu_torch.ckpt.convert import tree_from_model
from dualhyp_tpu_torch.models.gpt import merge_lora
from tests.test_torch_peft import _close, _model, _params, _prompts, _tensors
from tests.test_torch_quant import _flat


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("case", ["adapter", "adapter_v2", "lora_and_v2"])
def test_verify_step_matches_jax(case, kv_quant):
    """A speculative verify step of 5 tokens a row after prefill: logits and
    the greedy tokens against the JAX `verify_step`."""
    cfg, params = _params(case, seed=3)
    model = _model(cfg, params)
    ids, lengths = _prompts()
    chunk = np.random.default_rng(3).integers(3, 90, size=(3, 5)).astype(np.int32)
    jcache = jgpt.init_cache(cfg, 3, 30, dtype=jnp.float32, quantize=kv_quant)
    _, jcache = jgpt.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(lengths), jcache,
                             compute_dtype=jnp.float32)
    want, _ = jgpt.verify_step(params, cfg, jnp.asarray(chunk), jnp.asarray(lengths), jcache,
                               compute_dtype=jnp.float32)
    tids, tlens = _tensors(ids, lengths)
    cache = model.init_cache(3, 30, quantize=kv_quant)
    model.prefill(tids, tlens, cache)
    got = model.verify_step(torch.from_numpy(chunk).long(), tlens, cache)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("family", ["llama", "neox"])
def test_merge_lora_folds_the_mlp_as_jax(family):
    cfg, params = _params("lora_and_v2", family, seed=5)
    want = jax.tree_util.tree_map(np.asarray, jgpt.merge_lora(params, cfg))
    got = dict(_flat(tree_from_model(merge_lora(_model(cfg, params)))))
    assert sorted(got) == sorted(dict(_flat(want)))
    for key, value in _flat(want):
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5, err_msg=key)
