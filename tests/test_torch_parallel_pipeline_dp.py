"""The port's GPipe pipeline on a (data 2, pipe 2) mesh of 4 gloo CPU
ranks against the JAX package's over 4 virtual devices: `pipeline_logits`
equals the JAX `pipeline_logits` at 2e-5 and the gradients of sum(logits
* w) equal the JAX package's (tests/test_torch_pipeline.py's cases, whose
helpers this file shares); with LoRA dropout on, the hidden states are
deterministic in the generator, vary across generators, and equal the
dropout-off forward without one (the JAX masks cannot be matched bit for
bit, so the check is the JAX test's own). One spawn of 4 ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dualhyp_tpu.models import gpt as jgpt
from tests import helpers, torch_dist_worker
from tests.test_torch_pipeline import IDX, _cfg_dict, _params, check_logits_and_grads, logit_case

DROP_CFG = helpers.tiny_llama_config(n_layer=4, lora_r=4, lora_alpha=8, lora_dropout=0.5,
                                     lora_query=True, lora_value=True)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cases = [logit_case(2, 2, 2),
             dict(kind="pipe_dropout", mesh=dict(pipe=2, data=2), cfg=_cfg_dict(DROP_CFG),
                  tree=_params(DROP_CFG), idx=IDX[:, :10], n_micro=2)]
    return torch_dist_worker.Spawn(4, cases, tmp_path_factory.mktemp("pipe_dp"))


def test_pipeline_data2_logits_and_grads_match_jax(port):
    check_logits_and_grads(port.results()[0][0], 2, 2, 2)


def test_pipeline_dropout_deterministic_in_the_generator(port):
    h3, h3b, h4, off = port.results()[0][1]
    np.testing.assert_array_equal(h3, h3b)
    assert not np.allclose(h3, h4)
    params = jax.tree_util.tree_map(jnp.asarray, _params(DROP_CFG))
    idx = jnp.asarray(IDX[:, :10], jnp.int32)
    want = np.asarray(jgpt.forward(params, DROP_CFG, idx, compute_dtype=jnp.float32,
                                   return_hidden=True))
    # data rank 0's rows, in microbatch order (2 microbatches of 2 rows)
    np.testing.assert_allclose(off, want[[0, 2]], rtol=2e-5, atol=2e-5)
