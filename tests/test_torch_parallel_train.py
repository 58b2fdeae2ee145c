"""The port's sharded Trainer on 4 gloo CPU ranks against the JAX
package's `Trainer(mesh=...)` on 4 virtual devices: one LoRA step of a
tiny LLaMA under data 2 x fsdp 2, data 2 x tensor 2 and data 2 x seq 2
(T 32: the labels shift across the seq shards), and one mode-full step of
a tiny LLaMAMoE under data 2 x expert 2. The losses agree at rtol 1e-5,
atol 1e-6 (tests/test_parallel.py's), the updated trainable leaves within
1e-5, and `evaluate` on the mesh equals the JAX Trainer's after the step
at 1e-5. One spawn of 4 ranks runs every mesh while the JAX side
computes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dualhyp_tpu.parallel import make_mesh, shard_params
from dualhyp_tpu.train import TrainConfig, Trainer
from dualhyp_tpu_torch.parallel.sharding import leaves
from tests import helpers, torch_dist_worker

LORA = dict(lora_r=4, lora_alpha=8, lora_query=True, lora_key=True, lora_value=True,
            lora_projection=True)


def _cfg(kind):
    if kind == "lora":
        return helpers.tiny_llama_config(n_embd=64, intermediate_size=128, **LORA)
    return helpers.tiny_llama_config(n_embd=64, intermediate_size=128, mlp_class="LLaMAMoE",
                                     n_expert=4, n_expert_per_token=2)


# name: (config, mesh, TrainConfig fields beyond the common ones)
CASES = {
    "lora_data2_fsdp2": ("lora", dict(data=2, fsdp=2), {}),
    "lora_data2_tensor2": ("lora", dict(data=2, tensor=2), {}),
    "lora_data2_seq2": ("lora", dict(data=2, seq=2), {}),
    "full_moe_data2_expert2": ("moe", dict(data=2, expert=2), dict(mode="full")),
}
TCFG = dict(batch_size=4, micro_batch_size=4, compute_dtype="float32", lm_head_chunk_size=0)


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 96, (4, 32)).astype(np.int32)
    labels = ids.copy()
    labels[:, :8] = -1
    return {"input_ids": ids, "labels": labels}


def _params(cfg, seed=4):
    return torch_dist_worker.random_tree(cfg, seed)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cases = []
    for kind, mesh, extra in CASES.values():
        cfg = _cfg(kind)
        cases.append(dict(kind="train", mesh=mesh, tcfg=TCFG | extra, tree=_params(cfg),
                          batches=[_batch()],
                          cfg=torch_dist_worker.cfg_dict(cfg)))
    return torch_dist_worker.Spawn(4, cases, tmp_path_factory.mktemp("train"))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_train_step_matches_jax_mesh(port, case):
    kind, mesh_kw, extra = CASES[case]
    cfg = _cfg(kind)
    mesh = make_mesh(**mesh_kw, devices=jax.devices()[:4])
    sharded, _ = shard_params(jax.tree_util.tree_map(jnp.asarray, _params(cfg)), mesh)
    trainer = Trainer(cfg, TrainConfig(**TCFG, **extra), sharded, mesh=mesh)
    batch = _batch()
    loss, _ = trainer.train_step(batch, max_iters=10, warmup_steps=1, rng=jax.random.key(0))
    val = trainer.evaluate([batch])
    # the JAX trainable tree holds None where a leaf is frozen
    want = {k: v for k, v in leaves(jax.tree_util.tree_map(np.asarray, trainer.trainable))
            if v is not None}

    k = list(CASES).index(case)
    losses, trained, got_val = port.results()[0][k]
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_val, val, rtol=1e-5)
    got = dict(leaves(trained))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)
