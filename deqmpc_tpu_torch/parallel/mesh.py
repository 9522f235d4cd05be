"""The data-parallel layout of a run over processes.

Port of `deqmpc_tpu/parallel/mesh.py`, with JAX's names given their
`torch.distributed` meaning. JAX builds one mesh over every device and
lets `jit` place the shards; torch runs one process per device, so here a
"mesh" is the process group: every process holds the whole model (the
parameters replicated) and an equal slice of the global batch along its
leading axis, and the solver's batch-global reductions and the gradient
sync go through the group (`parallel.collectives`).

    world = initialize_multihost("localhost:29500", 2, rank)  # each process
    mesh = make_mesh()
    replicate(policy.model, mesh)          # rank 0's parameters everywhere
    local = shard_batch(global_batch, mesh)

With one process (no group) every helper is the identity.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import collectives

DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D "data" mesh: the process group (None with one process), its
    size, this process's rank and the device it drives."""

    group: Any
    world_size: int
    rank: int
    device: torch.device
    axis_name: str = "data"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout over the mesh: "batch" (an equal slice of the leading axis
    on each process) or "replicated" (the whole tensor on each)."""

    kind: str
    mesh: Mesh
    axis_name: Optional[str] = None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: Optional[str] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join a run of `num_processes` processes as `process_id`, through a
    TCP rendezvous at `coordinator_address` ("host:port", served by process
    0), over `backend` (nccl where CUDA is available, else gloo, when None).
    An init that does not complete within `timeout_s` raises. Without an
    address or a process count the run is one process and nothing is
    joined. Returns the process count."""
    if collectives.active():
        return dist.get_world_size()
    if coordinator_address is None and num_processes is None:
        return 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address, num_processes and "
                         "process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    address = coordinator_address.removeprefix("tcp://")
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device: Optional[torch.device] = None) -> Mesh:
    """The mesh of this run: one device per process, `device` this
    process's (the current CUDA device where there is one, else the CPU).
    `n_devices`, where given, must be the process count."""
    world = collectives.world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a torch process drives one device: a mesh of {n_devices} devices "
                         f"needs {n_devices} processes, this run has {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    group = dist.group.WORLD if collectives.active() else None
    return Mesh(group, world, collectives.rank(), torch.device(device), axis_name)


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> Sharding:
    """The leading (batch) axis split into equal slices, one per process."""
    return Sharding("batch", mesh, axis_name)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding("replicated", mesh)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_batch(batch, mesh: Mesh, axis_name: str = "data"):
    """This process's equal slice of each (global bsz, ...) array or tensor
    of `batch` (a dict, list or tuple of them, or one). A global bsz that
    the process count does not divide is refused."""
    if mesh.world_size == 1:
        return batch

    def take(x):
        bsz = x.shape[0]
        if bsz % mesh.world_size:
            raise ValueError(f"a global batch of {bsz} does not split over "
                             f"{mesh.world_size} processes")
        per = bsz // mesh.world_size
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    return _map(take, batch)


def shard_batch_local(batch, mesh: Mesh, global_bsz: Optional[int] = None,
                      axis_name: str = "data"):
    """A batch that this process loaded itself (its shard of the global
    batch): every leaf's leading axis must be the same, and, with
    `global_bsz`, `global_bsz / process count`. Returns the batch."""
    sizes = {int(np.shape(x)[0]) for x in _leaves(batch)}
    if len(sizes) != 1:
        raise ValueError(f"the local shard's leaves disagree on its size: {sorted(sizes)}")
    if global_bsz is not None and (global_bsz % mesh.world_size
                                   or sizes != {global_bsz // mesh.world_size}):
        raise ValueError(f"a local shard of {sizes.pop()} in a global batch of {global_bsz} "
                         f"over {mesh.world_size} processes")
    return batch


def replicate(tree, mesh: Mesh):
    """Process 0's copy of each tensor of `tree` (a module's parameters and
    buffers, or a dict, list or tuple of tensors) broadcast, in place, to
    every process. Returns `tree`."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in _leaves(tree):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return tree


def replicate_local(tree, mesh: Mesh):
    """Check that every process holds the same copy of each tensor of
    `tree`, bit for bit (the same seeded init on every process), and
    return it; a difference raises on every process."""
    if mesh.group is None:
        return tree
    same = torch.ones(1, dtype=torch.int32, device=mesh.device)
    with torch.no_grad():
        for t in _leaves(tree):
            ref = t.detach().clone()
            dist.broadcast(ref, src=0, group=mesh.group)
            if not torch.equal(ref, t.detach()):
                same.zero_()
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=mesh.group)
    if not bool(same[0]):
        raise ValueError("the processes' copies of the parameters differ")
    return tree
