"""The port's sharded forward on 4 gloo CPU ranks against the JAX
package's on 4 virtual devices: the logits of a tiny LLaMA with LoRA
(non-zero B) under data 2 x fsdp 2, data 2 x tensor 2 and data 2 x seq 2,
and of a tiny LLaMAMoE under data 2 x expert 2 (dense, and megablox with
the JAX gmm in Pallas interpret mode, as tests/test_torch_moe.py runs it),
at rtol and atol 5e-4 (tests/test_parallel.py's tolerance). One spawn of
4 ranks runs every mesh (tests/torch_dist_worker.py), while the JAX side
computes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas.ops.tpu import megablox
from jax.sharding import NamedSharding, PartitionSpec as P

from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.parallel import make_mesh, param_shardings
from tests import helpers, torch_dist_worker

LORA = dict(lora_r=4, lora_alpha=8, lora_query=True, lora_key=True, lora_value=True,
            lora_projection=True)


def _cfg(kind):
    if kind == "lora":
        return helpers.tiny_llama_config(n_embd=64, intermediate_size=128, **LORA)
    return helpers.tiny_llama_config(name=f"tiny-moe-{kind}", n_embd=64, intermediate_size=128,
                                     mlp_class="LLaMAMoE", n_expert=4, n_expert_per_token=2)


# name: (config, mesh, MoE implementation)
CASES = {
    "data2_fsdp2": ("lora", dict(data=2, fsdp=2), None),
    "data2_tensor2": ("lora", dict(data=2, tensor=2), None),
    "data2_seq2": ("lora", dict(data=2, seq=2), None),
    "data2_expert2_dense": ("dense", dict(data=2, expert=2), "dense"),
    "data2_expert2_megablox": ("megablox", dict(data=2, expert=2), "megablox"),
}
IDX = np.arange(4 * 16).reshape(4, 16) % 96


def _params(cfg, seed=4):
    return torch_dist_worker.random_tree(cfg, seed)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The 4-rank spawn over every case, started before the JAX side runs."""
    cases = []
    for kind, mesh, impl in CASES.values():
        cfg = _cfg(kind)
        cases.append(dict(kind="forward", mesh=mesh, moe_impl=impl, idx=IDX, tree=_params(cfg),
                          cfg=torch_dist_worker.cfg_dict(cfg)))
    return torch_dist_worker.Spawn(4, cases, tmp_path_factory.mktemp("fwd"))


def _jax_logits(cfg, params, mesh_kw):
    mesh = make_mesh(**mesh_kw, devices=jax.devices()[:4])
    shardings = param_shardings(params, mesh)
    axes = [("data", "fsdp"), "seq" if mesh_kw.get("seq", 1) > 1 else None]
    batch = NamedSharding(mesh, P(*axes))
    fwd = jax.jit(lambda p, i: jgpt.forward(p, cfg, i, compute_dtype=jnp.float32),
                  in_shardings=(shardings, batch))
    placed = jax.device_put(params, shardings)
    return np.asarray(fwd(placed, jax.device_put(jnp.asarray(IDX, jnp.int32), batch)))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_logits_match_jax_mesh(port, case, monkeypatch):
    kind, mesh_kw, impl = CASES[case]
    if impl == "megablox":
        monkeypatch.setattr(megablox, "gmm", functools.partial(megablox.gmm, interpret=True))
        monkeypatch.setenv("DUALHYP_MOE_IMPL", "megablox")
    else:
        monkeypatch.delenv("DUALHYP_MOE_IMPL", raising=False)
    cfg = _cfg(kind)
    want = _jax_logits(cfg, _params(cfg), mesh_kw)
    k = list(CASES).index(case)
    got = torch_dist_worker.assemble([r[k] for r in port.results()], mesh_kw, IDX.shape)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
