"""Adapter v1, v2 and LoRA-on-the-MLP models merged and quantized in the
port against the JAX package, on the CPU (the draws of test_torch_peft.py,
at width 256, the narrowest `quantize_tree` quantizes).

Tolerance: quantized logits 1e-4 absolute, as `test_torch_quant.py` holds
them (the same int8 / int4 bytes on both sides, fp32 sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.ops import quant as jquant
from dualhyp_tpu_torch.ckpt.convert import tree_from_model
from dualhyp_tpu_torch.models.gpt import merge_lora, quantize_model
from tests.test_torch_peft import CASES, _model, _params, _prompts, _tensors
from tests.test_torch_quant import _bits, _flat

# the narrowest width `quantize_tree` quantizes
WIDE = dict(n_embd=256, n_head=8, intermediate_size=512)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("case", CASES)
def test_quantized_adapter_models_match_jax(case, mode):
    """`--quantize`: the JAX package merges the LoRA deltas and runs
    `quantize_tree` (the adapter leaves stay beside the quantized weights);
    the port does the same to its model (`merge_lora`, `quantize_model`) and
    both hold the same bytes; prefill and a decode step."""
    cfg, params = _params(case, seed=4, **WIDE, n_query_groups=2)
    want_tree = jax.tree_util.tree_map(np.asarray, jquant.quantize_tree(
        jgpt.merge_lora(params, cfg) if cfg.any_lora else params, mode=mode))
    model = _model(cfg, params)
    if cfg.any_lora:
        merge_lora(model)
    quantize_model(model, mode)
    got_tree = dict(_flat(tree_from_model(model)))
    assert sorted(got_tree) == sorted(dict(_flat(want_tree)))
    for key, value in _flat(want_tree):
        if "_q" in key.rsplit("/", 1)[-1]:  # the quantized codes: the same bytes
            np.testing.assert_array_equal(_bits(got_tree[key]), _bits(value), err_msg=key)
    assert model.blocks[0].mlp.fc_1.quant == mode
    ids, lengths = _prompts(9)
    tids, tlens = _tensors(ids, lengths)
    jcache = jgpt.init_cache(cfg, 3, 16, dtype=jnp.float32)
    want, jcache = jgpt.prefill(want_tree, cfg, jnp.asarray(ids), jnp.asarray(lengths), jcache,
                                compute_dtype=jnp.float32)
    cache = model.init_cache(3, 16)
    np.testing.assert_allclose(model.prefill(tids, tlens, cache).numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    token = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    want, _ = jgpt.decode_step(want_tree, cfg, jnp.asarray(token), jnp.asarray(lengths),
                               jcache, compute_dtype=jnp.float32)
    got = model.decode_step(torch.from_numpy(token).long(), tlens, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
