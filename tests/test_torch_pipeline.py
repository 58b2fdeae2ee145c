"""The port's GPipe pipeline on gloo CPU ranks against the JAX package's
over virtual devices (a tiny 2-layer LLaMA with LoRA, non-zero B):
`pipeline_logits` at (stages, n_micro) = (2, 2) and (2, 1) on 2 ranks
(and, in tests/test_torch_parallel_pipeline_dp.py, on a (data 2, pipe 2)
mesh on 4 ranks) equals the JAX `pipeline_logits` at 2e-5, and the gradients of sum(logits * w) with respect to every leaf equal
the JAX package's (5e-5 / 5e-6, tests/test_pipeline.py's), taken through
its unpipelined forward (tests/test_pipeline.py holds the JAX pipeline's
gradients to those; tracing its own backward here costs ~30 s); three Trainer
steps with pipeline_stages=2 give the JAX Trainer's losses at 1e-5 (its
unpipelined step, which tests/test_pipeline.py holds the pipelined to).
One spawn of 2 ranks, started before the JAX side computes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.parallel.pipeline import make_pipe_mesh, pipeline_logits
from dualhyp_tpu.train import TrainConfig, Trainer
from dualhyp_tpu_torch.parallel.sharding import leaves
from tests import helpers, torch_dist_worker

LORA = dict(lora_r=4, lora_alpha=8, lora_query=True, lora_key=True, lora_value=True,
            lora_projection=True)
CFG = helpers.tiny_llama_config(n_layer=2, **LORA)
RNG = np.random.default_rng(0)
IDX = RNG.integers(1, 96, (4, 12)).astype(np.int64)
COT = (RNG.normal(size=(4, 12, CFG.padded_vocab_size)) / (4 * 12)).astype(np.float32)
# (stages, data, n_micro) of the pipeline_logits cases
LOGIT_CASES = {"stages2_micro2": (2, 1, 2), "stages2_micro1": (2, 1, 1)}
TCFG = dict(batch_size=4, micro_batch_size=4, compute_dtype="float32",
            pipeline_stages=2, pipeline_microbatches=2)


_cfg_dict = torch_dist_worker.cfg_dict


def _params(cfg, seed=2):
    return torch_dist_worker.random_tree(cfg, seed, lora_b=0.5)


def _batches():
    rng = np.random.default_rng(1)
    out = []
    for _ in range(3):
        ids = rng.integers(1, 96, (4, 16)).astype(np.int32)
        labels = ids.copy()
        labels[:, :4] = -1
        out.append({"input_ids": ids, "labels": labels})
    return out


def logit_case(stages, data, n_micro):
    return dict(kind="pipeline", mesh=dict(pipe=stages, data=data), cfg=_cfg_dict(CFG),
                tree=_params(CFG), idx=IDX, cotangent=COT, n_micro=n_micro)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cases = [logit_case(*LOGIT_CASES[name]) for name in LOGIT_CASES]
    cases.append(dict(kind="train", mesh=None, cfg=_cfg_dict(CFG), tcfg=TCFG, tree=_params(CFG),
                      batches=_batches()))
    return torch_dist_worker.Spawn(2, cases, tmp_path_factory.mktemp("pipe"))


@functools.lru_cache(maxsize=None)
def _jax_grads():
    params = jax.tree_util.tree_map(jnp.asarray, _params(CFG))
    idx = jnp.asarray(IDX, jnp.int32)
    return jax.jit(jax.grad(lambda p: (jgpt.forward(p, CFG, idx, compute_dtype=jnp.float32)
                                       * COT).sum()))(params)


def check_logits_and_grads(result, stages, data, n_micro):
    """A `pipeline` case's (logits, grads) against the JAX package's."""
    params = jax.tree_util.tree_map(jnp.asarray, _params(CFG))
    mesh = make_pipe_mesh(stages, data=data)
    idx = jnp.asarray(IDX, jnp.int32)
    want = np.asarray(jax.jit(lambda p, i: pipeline_logits(p, CFG, i, mesh, n_micro=n_micro))(
        params, idx))
    grads = _jax_grads()
    logits, got_grads = result
    np.testing.assert_allclose(logits, want, rtol=2e-5, atol=2e-5)
    flat = {k.replace("/", "::"): np.asarray(v) for k, v in leaves(
        jax.tree_util.tree_map(np.asarray, grads))}
    assert set(got_grads) == set(flat)
    for key, g in flat.items():
        np.testing.assert_allclose(got_grads[key], g, rtol=5e-5, atol=5e-6, err_msg=key)


@pytest.mark.parametrize("case", list(LOGIT_CASES))
def test_pipeline_logits_and_grads_match_jax(port, case):
    check_logits_and_grads(port.results()[0][list(LOGIT_CASES).index(case)], *LOGIT_CASES[case])


def test_trainer_pipeline_losses_match_jax(port):
    # the JAX Trainer without stages: tests/test_pipeline.py holds its
    # pipelined losses to these
    tcfg = {k: v for k, v in TCFG.items() if not k.startswith("pipeline")}
    trainer = Trainer(CFG, TrainConfig(**tcfg), jax.tree_util.tree_map(jnp.asarray, _params(CFG)))
    want = [float(trainer.train_step(b, max_iters=10, warmup_steps=1,
                                     rng=jax.random.key(i))[0])
            for i, b in enumerate(_batches())]
    losses, _, _ = port.results()[0][len(LOGIT_CASES)]
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-6)
