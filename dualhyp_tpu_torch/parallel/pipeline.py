"""GPipe pipeline parallelism over a `pipe` axis of ranks.

Counterpart of `dualhyp_tpu/parallel/pipeline.py`. The block stack splits
into contiguous stages: rank p of the `pipe` axis holds layers
[p L / P, (p + 1) L / P) (`GPT(mesh=make_pipe_mesh(...))`; n_layer %
stages == 0). Microbatches flow through the stages on the classic GPipe
fill-drain schedule of M + P - 1 ticks: at tick t stage p runs microbatch
t - p and hands its output to stage p + 1 with `comm.ppermute`. Every rank
runs its stage at every tick (the bubble ticks on a clamped microbatch, as
the JAX package's scan does) and every rank's graph has the same ops in the
same order, so the backward's collectives meet: stage 0 takes the feed and
the others the handed-over state through `torch.where`, whose gradient
reaches both. The last stage's outputs are all-reduced over `pipe` with the
others' masked to zero (the JAX package's psum; its backward is the
identity, `comm.reduce_from`), and the embedded input enters through
`comm.copy_to`, so its gradient sums over the stages. Embedding, final
norm and head run replicated on every stage.

A ("data", "pipe") mesh shards each microbatch's rows over `data`
(`local_rows`), the pp x dp layout.

Dropout: one seed a layer from the generator (as `GPT.forward` draws them),
folded with the microbatch index, so every (layer, microbatch) draws its
own masks, deterministic in the generator. The masks cannot be the JAX
package's bit for bit; at dropout 0 the outputs equal the unpipelined
forward.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dualhyp_tpu_torch.parallel import comm
from dualhyp_tpu_torch.parallel.mesh import Mesh, _world

# the fold of a microbatch index into a layer's dropout seed
_FOLD = 0x9E3779B97F4A7C15


def make_pipe_mesh(stages: int, data: int = 1, *, world_size=None, rank=None) -> Mesh:
    """The ("pipe",) mesh, or ("data", "pipe") when data > 1, over the
    process group's ranks (world_size and rank: a mesh with no process
    group). The world must hold stages x data ranks."""
    live = dist.is_initialized() and world_size is None
    n, rank = _world(world_size, rank)
    assert n == stages * data, (n, stages, data)
    if data > 1:
        return Mesh(("data", "pipe"), (data, stages), rank=rank, with_groups=live)
    return Mesh(("pipe",), (stages,), rank=rank, with_groups=live)


def local_rows(batch: int, n_micro: int, data: int, index: int) -> np.ndarray:
    """The rows of a (batch, ...) array that data rank `index` holds, in
    microbatch order: the batch is n_micro microbatches of batch / n_micro
    rows, each split over `data` ranks."""
    assert batch % n_micro == 0, (batch, n_micro)
    mb = batch // n_micro
    assert mb % data == 0, (mb, data)
    mbl = mb // data
    return (np.arange(n_micro)[:, None] * mb + index * mbl + np.arange(mbl)[None]).reshape(-1)


def pipeline_blocks(model, x_micro, cos, sin, mesh: Mesh, seeds=None):
    """Run the block stack over microbatches through the pipeline.

    model: the stage's `GPT` (built on `mesh`); x_micro: (M, mb, T, D)
    embedded activations (this data rank's rows); seeds: one dropout seed
    a layer (None: no dropout). Returns (M, mb, T, D), the last stage's
    outputs, on every stage."""
    stages, p = mesh.shape["pipe"], mesh.coords["pipe"]
    group = mesh.group("pipe")
    n_micro = x_micro.shape[0]
    x_micro = comm.copy_to(x_micro, group)
    first = torch.tensor(p == 0, device=x_micro.device)
    blocks = model.local_blocks

    def stage(x, m):
        for i, block in blocks:
            seed = None if seeds is None else (seeds[i] + m * _FOLD) % 2**62
            x = model._call(block, block, x, cos, sin, seed=seed)
        return x

    state = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(n_micro + stages - 1):
        # stage 0 takes microbatch t (clamped in the drain), the others the
        # previous tick's handover; stage p runs microbatch t - p
        x_in = torch.where(first, x_micro[min(t, n_micro - 1)], state)
        out = stage(x_in, min(max(t - p, 0), n_micro - 1))
        if t >= stages - 1:
            outs.append(out)  # the last stage completes microbatch t - (P - 1)
        state = comm.ppermute(out, group)
    y = torch.stack(outs)
    return comm.reduce_from(y * float(p == stages - 1), group)


def pipeline_hidden(model, idx, mesh: Mesh, *, n_micro: int = 2, generator=None,
                    local: bool = False):
    """Final normed hidden states with the block stack pipelined. idx: (B,
    T) token ids, B % n_micro == 0; this data rank's rows are taken
    (`local_rows`) unless `local` (idx are those rows already). generator:
    draws the layers' dropout seeds (None: no dropout). Returns this data
    rank's rows (B / data, T, D), in microbatch order."""
    cfg = model.cfg
    if not local and "data" in mesh.shape:
        idx = idx[torch.as_tensor(local_rows(idx.shape[0], n_micro, mesh.shape["data"],
                                             mesh.index("data")), device=idx.device)]
    b, t = idx.shape
    assert b % n_micro == 0, (b, n_micro)
    seeds = None
    if generator is not None and cfg.lora_dropout > 0:
        seeds = torch.randint(0, 2**62, (cfg.n_layer,), generator=generator,
                              device=generator.device).tolist()
    x = model._embed(idx)
    y = pipeline_blocks(model, x.reshape(n_micro, b // n_micro, t, -1),
                        model.cos[:t], model.sin[:t], mesh, seeds=seeds)
    return model._norm_f(y.reshape(b, t, -1))


def pipeline_logits(model, idx, mesh: Mesh, *, n_micro: int = 2, generator=None):
    """The full forward with the block stack pipelined: fp32 logits (B, T,
    padded_vocab) of every row of idx (B, T), on every rank; equal to
    `GPT.forward`."""
    logits = model.head_logits(pipeline_hidden(model, idx, mesh, n_micro=n_micro,
                                               generator=generator))
    if "data" not in mesh.shape:
        return logits
    data = mesh.shape["data"]
    b = idx.shape[0]
    parts = comm.gather_from(logits, 0, mesh.group("data"))
    rows = np.concatenate([local_rows(b, n_micro, data, d) for d in range(data)])
    out = torch.empty_like(parts)
    out[torch.as_tensor(rows, device=parts.device)] = parts
    return out
