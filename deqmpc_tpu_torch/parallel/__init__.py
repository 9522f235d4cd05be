"""Data parallelism over processes (`deqmpc_tpu/parallel/__init__.py`).

All of the model's parallelism is the batch axis: per-sample solver state
is independent, so a training step over P processes needs the gradient
all-reduce and the solver's few batch-global reductions
(`collectives`), nothing else. One process per device, as torch runs it:

    initialize_multihost("localhost:29500", num_processes=2, process_id=rank)
    mesh = make_mesh()
    replicate(policy.model, mesh)
    batch = shard_batch(global_batch, mesh)
    train.train_step(policy, optimizer, batch)  # gradients averaged inside
"""
from . import collectives
from .mesh import (Mesh, Sharding, batch_sharding, initialize_multihost, make_mesh,
                   replicate, replicate_local, replicated_sharding, shard_batch,
                   shard_batch_local)

__all__ = [
    "Mesh",
    "Sharding",
    "batch_sharding",
    "collectives",
    "initialize_multihost",
    "make_mesh",
    "replicate",
    "replicate_local",
    "replicated_sharding",
    "shard_batch",
    "shard_batch_local",
]
