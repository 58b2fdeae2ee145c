"""Scale-out on torch.distributed: the counterpart of `dualhyp_tpu/parallel`.

One process a card; a mesh of named axes (`mesh`), the collectives that
GSPMD inserts in the JAX package (`comm`), the sharding rules of the
parameter tree (`sharding`) and GPipe over a `pipe` axis (`pipeline`)."""

from dualhyp_tpu_torch.parallel.mesh import AXES, Mesh, init_distributed, make_mesh
from dualhyp_tpu_torch.parallel.pipeline import (
    make_pipe_mesh, pipeline_blocks, pipeline_hidden, pipeline_logits)
from dualhyp_tpu_torch.parallel.sharding import (
    batch_sharding, param_shardings, replicated, shard_params)

__all__ = [
    "AXES",
    "Mesh",
    "init_distributed",
    "make_mesh",
    "make_pipe_mesh",
    "pipeline_blocks",
    "pipeline_hidden",
    "pipeline_logits",
    "batch_sharding",
    "param_shardings",
    "replicated",
    "shard_params",
]
