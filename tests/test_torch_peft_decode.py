"""Adapter v1, v2 and LoRA-on-the-MLP decoding in the port against the JAX
package, on the CPU (the configs and draws of test_torch_peft.py): prefill
and a decode step (logits, K/V caches: the prefix's K/V never enter them),
greedy tokens with a float and an int8 KV cache.

Tolerances: logits 1e-5 of the largest logit; caches 1e-5 absolute; greedy
tokens exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.infer.decode import generate as jax_generate
from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu_torch.infer.decode import generate
from tests.test_torch_peft import CASES, _close, _model, _params, _prompts, _tensors


@pytest.mark.parametrize("family", ["llama", "neox"])
@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_jax(case, family):
    """Prefill and one decode step: logits and the K/V caches (the prefix's
    K/V are not in them)."""
    cfg, params = _params(case, family, seed=1)
    model = _model(cfg, params)
    ids, lengths = _prompts()
    jcache = jgpt.init_cache(cfg, 3, 16, dtype=jnp.float32)
    want, jcache = jgpt.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                jcache, compute_dtype=jnp.float32)
    cache = model.init_cache(3, 16)
    tids, tlens = _tensors(ids, lengths)
    _close(model.prefill(tids, tlens, cache).numpy(), want)
    token = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    want, jcache = jgpt.decode_step(params, cfg, jnp.asarray(token), jnp.asarray(lengths),
                                    jcache, compute_dtype=jnp.float32)
    _close(model.decode_step(torch.from_numpy(token).long(), tlens, cache).numpy(), want)
    for i, name in enumerate(("k", "v")):
        stacked = torch.stack([layer[i] for layer in cache]).numpy()
        np.testing.assert_allclose(stacked, np.asarray(jcache[name]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("case", CASES)
def test_greedy_tokens_match_jax(case, kv_quant):
    cfg, params = _params(case, seed=2)
    model = _model(cfg, params)
    ids, lengths = _prompts(8)
    want_toks, want_lens = jax_generate(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                        max_new_tokens=6, top_k=1, compute_dtype=jnp.float32,
                                        kv_quant=kv_quant)
    got_toks, got_lens = generate(model, torch.from_numpy(ids), torch.from_numpy(lengths),
                                  max_new_tokens=6, top_k=1, kv_quant=kv_quant)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))
