"""The device mesh: one process a card, ranks laid out on named axes.

Counterpart of `dualhyp_tpu/parallel/mesh.py`. The axes are the JAX
package's, in its order:

  * `data`   - data parallel: the batch shards over it;
  * `fsdp`   - ZeRO-3-style parameter sharding; its ranks consume data too;
  * `tensor` - Megatron tensor parallel;
  * `expert` - expert parallel: an MoE's expert stacks shard over it;
  * `seq`    - sequence parallel: activations shard over tokens.

The JAX package is single-controller: one process drives every device and
GSPMD inserts the collectives. The port is SPMD multi-controller: one
process a card (started by `torchrun`, or by a test's spawner), with the
collectives written out (`parallel/comm.py`). Global rank r sits at the
C-order coordinates of r in the grid (data, fsdp, tensor, expert, seq),
the order in which `make_mesh` of the JAX package reshapes its devices.

`Mesh` is the port's own grid of process groups rather than a
`torch.distributed.device_mesh.DeviceMesh`: the trainer reduces gradients
over unions of axes (data x fsdp x seq, data x seq) and the MoE over
tensor x expert, which a DeviceMesh gives only through `_flatten`, whose
form has changed between torch releases; and a mesh here may be built with
no process group at all (`world_size` and `rank` given), which the
meta-device shape checks use. A group for every union of the axes whose
extent is above 1 is made once, in the same order on every rank, when a
process group is initialised; `group(*axes)` returns it (None for an
extent of 1). Within such a group the ranks run in C order over the
group's axes, as `torch.distributed.new_group` sorts them.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "tensor", "expert", "seq")


class Mesh:
    """A grid of `world_size` ranks over named axes (C order), with this
    process's coordinates and the process groups of its axis unions."""

    def __init__(self, axis_names, extents, *, rank: int, with_groups: bool):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(e) for e in extents)))
        self.size = math.prod(self.shape.values())
        self.rank = int(rank)
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        idx = self.rank
        coords = {}
        for name in reversed(self.axis_names):
            coords[name] = idx % self.shape[name]
            idx //= self.shape[name]
        self.coords = {name: coords[name] for name in self.axis_names}
        self._groups = {}
        self.live = with_groups
        if with_groups:
            self._make_groups()

    def extent(self, *axes) -> int:
        """The product of the axes' extents (1 for an axis the mesh lacks)."""
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, *axes) -> int:
        """This rank's position in C order over `axes` (0 for none)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape.get(a, 1) + self.coords.get(a, 0)
        return idx

    def _members(self, axes, coords) -> list:
        """The global ranks that share `coords` off `axes`, in C order."""
        ranks = []
        for combo in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(coords, **dict(zip(axes, combo)))
            r = 0
            for name in self.axis_names:
                r = r * self.shape[name] + c[name]
            ranks.append(r)
        return ranks

    def _make_groups(self) -> None:
        """One process group for each union of the axes above extent 1:
        every rank makes every group (new_group is collective), in the same
        order, and keeps the one it belongs to."""
        live = [a for a in self.axis_names if self.shape[a] > 1]
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
                rest = [a for a in self.axis_names if a not in axes]
                mine = None
                for combo in itertools.product(*(range(self.shape[a]) for a in rest)):
                    coords = dict(zip(rest, combo))
                    coords.update({a: 0 for a in axes})
                    ranks = self._members(axes, coords)
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = group
                self._groups[axes] = mine

    def group(self, *axes):
        """The process group over the union of `axes` (in the mesh's order)
        that this rank belongs to; None where their extent is 1, and on a
        mesh made with no process group (shapes only: nothing runs on it)."""
        axes = tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)
        if not axes or not self.live:
            return None
        return self._groups[axes]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _world(world_size, rank):
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return world_size, rank


def make_mesh(data: Optional[int] = None, fsdp: int = 1, tensor: int = 1, expert: int = 1,
              seq: int = 1, *, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The (data, fsdp, tensor, expert, seq) mesh over the process group's
    ranks (`make_mesh` of the JAX package, the same extent rules): `data`
    defaults to the world size over the model axes, and extents whose
    product is not the world size raise. world_size and rank: a mesh with
    no process group (shape checks); the group's when None."""
    live = dist.is_initialized() and world_size is None
    n, rank = _world(world_size, rank)
    model_axes = fsdp * tensor * expert * seq
    if data is None:
        assert n % model_axes == 0, (n, fsdp, tensor, expert, seq)
        data = n // model_axes
    assert data * model_axes == n, (
        f"mesh {data}x{fsdp}x{tensor}x{expert}x{seq} != {n} devices"
    )
    return Mesh(AXES, (data, fsdp, tensor, expert, seq), rank=rank, with_groups=live)


def init_distributed(backend: Optional[str] = None, device=None) -> torch.device:
    """Join the job's process group from torchrun's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`; counterpart of
    `initialize_distributed` of the JAX package), unless this process has
    joined one already. The card `cuda:LOCAL_RANK` with NCCL unless asked
    otherwise; device "cpu" takes gloo. With no card and no device named it
    raises, as `device.resolve_device` does. Returns this rank's device."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on gloo ranks")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return device
