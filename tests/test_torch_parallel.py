"""The port's mesh and sharding rules against the JAX package's, in one
process (no process group): `make_mesh`'s extents and errors; the spec of
every leaf of LLaMA-, LLaMAMoE- and phi-shaped trees under each axis,
exactly; each rank's pieces of a tree against the shard that `device_put`
places on the virtual device at the rank's mesh coordinates, exactly; the
sharded model's local shapes on the meta device for Llama-2-7b under fsdp
8 and Mixtral-8x7B under fsdp 4 x expert 2 against the JAX shard shapes
over `jax.eval_shape`; `init_distributed` without a card."""

import jax
import numpy as np
import pytest
import torch

from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.parallel import make_mesh as jax_make_mesh
from dualhyp_tpu.parallel import param_shardings as jax_param_shardings
from dualhyp_tpu.registry import config_from_name as jax_config_from_name
from dualhyp_tpu_torch.models.gpt import GPT
from dualhyp_tpu_torch.parallel import (
    batch_sharding, init_distributed, make_mesh, param_shardings, replicated, shard_params)
from dualhyp_tpu_torch.parallel.sharding import leaves
from dualhyp_tpu_torch.registry import config_from_name
from tests import helpers

LORA = dict(lora_r=4, lora_alpha=8, lora_query=True, lora_key=True, lora_value=True,
            lora_projection=True)

TREES = {
    "llama_lora": lambda: helpers.tiny_llama_config(
        n_embd=64, intermediate_size=128, lora_mlp=True, lora_head=True, **LORA),
    "llama_moe": lambda: helpers.tiny_llama_config(
        n_embd=64, intermediate_size=128, mlp_class="LLaMAMoE", n_expert=4,
        n_expert_per_token=2, **LORA),
    "phi": lambda: jax_config_from_name("phi-2", lora_mlp=True, **LORA),
    "phi_tiny": lambda: helpers.tiny_config(shared_attention_norm=True, lm_head_bias=True,
                                            gelu_approximate="tanh", **LORA),
}

MESHES = {
    "data8": {},
    "data2_fsdp4": dict(data=2, fsdp=4),
    "tensor2": dict(data=4, tensor=2),
    "expert2": dict(data=4, expert=2),
    "fsdp2_tensor2_expert2": dict(data=1, fsdp=2, tensor=2, expert=2),
    "seq2": dict(data=4, seq=2),
}


def _spec(p):
    return tuple(p)


def _shapes(cfg):
    """The JAX init's leaves as zero-size views of their shapes."""
    abstract = jax.eval_shape(lambda k: jgpt.init(cfg, k), jax.random.key(0))
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.uint8), s.shape), abstract)


def test_mesh_shapes():
    mesh = make_mesh(world_size=8)
    assert mesh.shape["data"] == 8 and mesh.shape["fsdp"] == 1
    mesh = make_mesh(data=2, fsdp=4, world_size=8)
    assert mesh.shape["data"] == 2 and mesh.shape["fsdp"] == 4
    jmesh = jax_make_mesh(data=2, fsdp=4)
    assert tuple(mesh.shape.items()) == tuple(jmesh.shape.items())
    with pytest.raises(AssertionError):
        make_mesh(data=3, fsdp=3, world_size=8)
    with pytest.raises(AssertionError, match="mesh 2x3x1x1x1 != 8 devices"):
        make_mesh(data=2, fsdp=3, world_size=8)
    # the rank's coordinates are its C-order place in the grid, as the JAX
    # package reshapes its devices
    jmesh = jax_make_mesh(data=2, fsdp=1, tensor=2, expert=2)
    for r in range(8):
        m = make_mesh(data=2, tensor=2, expert=2, world_size=8, rank=r)
        where = np.argwhere(np.vectorize(lambda d: d.id)(jmesh.devices) == jax.devices()[r].id)
        assert tuple(where[0]) == tuple(m.coords.values())
    assert replicated(mesh) == () and batch_sharding(mesh) == (("data", "fsdp"),)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("tree", TREES)
def test_param_shardings_equal_jax(tree, mesh_name):
    cfg = TREES[tree]()
    shapes = _shapes(cfg)
    kw = MESHES[mesh_name]
    jmesh = jax_make_mesh(**kw)
    want = jax_param_shardings(shapes, jmesh)
    got = param_shardings(shapes, make_mesh(**kw, world_size=8))
    want_flat = {"/".join(str(k.key) for k in path): _spec(s.spec)
                 for path, s in jax.tree_util.tree_leaves_with_path(want)}
    got_flat = dict(leaves(got))
    assert got_flat == want_flat


@pytest.mark.parametrize("mesh_name", ["data2_fsdp4", "fsdp2_tensor2_expert2"])
@pytest.mark.parametrize("tree", ["llama_lora", "llama_moe", "phi_tiny"])
def test_shard_params_pieces_equal_jax(tree, mesh_name):
    cfg = TREES[tree]()
    params = jgpt.init(cfg, jax.random.key(1))
    host = jax.tree_util.tree_map(np.asarray, params)
    kw = MESHES[mesh_name]
    jmesh = jax_make_mesh(**kw)
    placed = jax.device_put(params, jax_param_shardings(params, jmesh))
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    want = {}  # (rank, path) -> the shard on the device at the rank's coords
    for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
        key = "/".join(str(k.key) for k in path)
        for shard in leaf.addressable_shards:
            coords = np.argwhere(ids == shard.device.id)[0]
            rank = int(np.ravel_multi_index(tuple(coords), ids.shape))
            want[rank, key] = np.asarray(shard.data)
    for rank in range(8):
        pieces, _ = shard_params(host, make_mesh(**kw, world_size=8, rank=rank))
        for key, piece in leaves(pieces):
            np.testing.assert_array_equal(piece, want[rank, key], err_msg=f"{rank} {key}")


LARGE = {
    "llama2_7b_fsdp8": ("Llama-2-7b-hf", LORA | dict(lora_r=16, lora_alpha=16), dict(fsdp=8)),
    "mixtral_fsdp4_expert2": ("Mixtral-8x7B-v0.1", {}, dict(fsdp=4, expert=2)),
}


@pytest.mark.parametrize("case", LARGE)
def test_meta_device_local_shapes_match_jax_shards(case):
    """The sharded model on the meta device, each rank passed explicitly:
    every local parameter has the shape of the JAX shard (the layer axis
    aside) of its leaf under the JAX `param_shardings`, but the LoRA leaves,
    which the port keeps whole over `tensor` (none here)."""
    name, overrides, kw = LARGE[case]
    jcfg = jax_config_from_name(name, **overrides)
    abstract = jax.eval_shape(lambda k: jgpt.init(jcfg, k), jax.random.key(0))
    jmesh = jax_make_mesh(data=1, **kw)
    shards = jax_param_shardings(abstract, jmesh)
    want = {}
    for (path, leaf), (_, sh) in zip(jax.tree_util.tree_leaves_with_path(abstract),
                                     jax.tree_util.tree_leaves_with_path(shards)):
        key = "/".join(str(k.key) for k in path)
        want[key] = tuple(sh.shard_shape(leaf.shape))
    cfg = config_from_name(name, **overrides)
    for rank in (0, 5):
        model = GPT(cfg, device="meta", dtype=torch.bfloat16,
                    mesh=make_mesh(**kw, world_size=8, rank=rank))
        seen = set()
        for pname, p in model.named_parameters():
            assert p.is_meta
            key, stacked = GPT.leaf_path(pname)
            assert tuple(p.shape) == want[key][int(stacked):], pname
            seen.add(key)
        assert seen == set(want)


def test_init_distributed_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed()


def test_multi_rank_worker_and_parallel_import_no_jax():
    """The spawned ranks import tests/torch_dist_worker.py afresh: it and the
    `parallel` package import neither JAX nor the JAX package."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    code = ("import json, sys\n"
            "import tests.torch_dist_worker, dualhyp_tpu_torch.parallel\n"
            "from dualhyp_tpu_torch.parallel import comm, mesh, pipeline, sharding\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dualhyp_tpu'))))")
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
