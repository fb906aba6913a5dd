"""The mesh of ranks: axis names and sizes over `torch.distributed`.

Counterpart of `plotpointe_tpu/parallel/mesh.py` (`parse_mesh_shape`,
`make_mesh`, `replicated`, `row_sharded`). Axis convention as in JAX:

  "data"  - batch / graph-partition axis: tables and graph shards split here
  "model" - reserved for tensor-sharding wide hidden dims; the trainer
            replicates over it

The process model differs from JAX's. JAX runs one controller over N
devices (`shard_map` and collectives inside one program, or one controller
per host under `jax.distributed`); the port runs one process per rank and
one rank per device, so both JAX modes are the same here: a process group
of N ranks. `make_mesh` lays the group's ranks out row-major over the axes
(rank = flat index of its coordinates) and builds, with `dist.new_group`,
the subgroup of ranks that share every coordinate but "data": the group
the data axis's collectives run over. Ranks that differ only in "model"
hold the same shards and compute the same values.

Without a process group, a mesh of one rank starts a group of its own on a
free localhost port (NCCL on CUDA, gloo on the CPU); a larger mesh needs
the ranks launched first (`multihost.spawn`, `torchrun`, or the
PLOTPOINTE_* variables of `multihost.maybe_initialize_distributed`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA = "data"


def parse_mesh_shape(spec: str) -> Dict[str, int]:
    """Parse "data:4,model:2" -> {"data": 4, "model": 2}."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        name, _, size = part.strip().partition(":")
        out[name] = int(size)
    return out


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh. `group` is the data axis's process
    group (None: the default group, when "data" is the only axis)."""

    shape: Tuple[Tuple[str, int], ...]  # (axis, size) in order
    rank: int  # in the default group
    world_size: int
    device: torch.device
    group: Optional[object]
    coords: Tuple[int, ...]  # this rank's place on each axis

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.shape)

    def size(self, axis: str = DATA) -> int:
        return dict(self.shape).get(axis, 1)

    def axis_index(self, axis: str = DATA) -> int:
        """This rank's coordinate on `axis` (JAX's `lax.axis_index`)."""
        return self.coords[self.axis_names.index(axis)] if axis in self.axis_names else 0

    @property
    def n_shards(self) -> int:
        return self.size(DATA)

    @property
    def shard(self) -> int:
        return self.axis_index(DATA)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(rank: int, device=None) -> torch.device:
    """The device rank `rank` runs on: `device` when it names one (`cuda:1`,
    `cpu`), else `cuda:<local rank>`; None means CUDA."""
    from plotpointe_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(shape: Optional[Dict[str, int] | str] = None, device=None) -> Mesh:
    """This rank's `Mesh` over the process group (default shape: one "data"
    axis over every rank). The mesh must hold every rank of the group."""
    from plotpointe_tpu_torch.parallel.multihost import maybe_initialize_distributed

    if isinstance(shape, str):
        shape = parse_mesh_shape(shape)
    total = None if shape is None else int(np.prod(list(shape.values())))
    if not dist.is_initialized() and not maybe_initialize_distributed(device=device):
        if total not in (None, 1):
            raise ValueError(f"mesh shape {shape} needs {total} ranks and no process group is "
                             "running: spawn the ranks (parallel.multihost.spawn) or launch them "
                             "with torchrun")
        maybe_initialize_distributed(num_processes=1, process_id=0, device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = dict(shape) if shape is not None else {DATA: world}
    total = int(np.prod(list(shape.values())))
    if total != world:
        raise ValueError(f"mesh shape {shape} needs {total} ranks; the process group has {world}")
    sizes = list(shape.values())
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    group = None
    if DATA in shape and len(shape) > 1:
        # every rank creates every data subgroup, in the same order
        axis = list(shape).index(DATA)
        grid = np.arange(world).reshape(sizes)
        lines = np.moveaxis(grid, axis, -1).reshape(-1, sizes[axis])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                group = g
    dev = rank_device(rank, device) if device is None or torch.device(device).index is None \
        else torch.device(device)
    return Mesh(tuple(shape.items()), rank, world, dev, group, coords)


def replicated(mesh: Mesh) -> Tuple[str, ...]:
    """Placement of a tensor every rank holds whole: no sharded dim."""
    return ()


def row_sharded(mesh: Mesh, axis: str = DATA) -> Tuple[str, ...]:
    """Placement of a tensor whose dim 0 (table rows, batch) is split over
    `axis`: rank k holds its k-th block (`sharded_table.shard_size` rows)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    return (axis,)
