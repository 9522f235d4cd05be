"""The batch-global reductions of a data-parallel run.

Under JAX's mesh every batch-wide reduction of the solver stays global by
construction (`jit` over a sharded batch). Under `torch.distributed` each
process holds one equal shard of the batch, so the solver's batch-global
decisions read their reductions through this module:

  * `global_norm`: the residual norm of the Newton exit and of the
    linearize-once stall exit (`solvers/newton_al.py`, `solvers/al_mpc.py`);
  * `all_true`: the Newton solve's retry, taken by the whole batch when any
    sample on any process is non-finite;
  * `batch_mean`: the line search's mean step size;
  * `amax`: the streaming rho-cap exit and the linearize-once rho exit;
  * `row_mean`: the `grad_norm` backward's per-channel batch mean;
  * `gather_batch`: `update_scales`' medians over the whole batch;
  * `average_gradients` and `average_scalars`: the gradient sync of a
    training step and its logged batch means.

Every reduction goes through the default process group when one is
initialised, whatever its size (one process all-reduces with itself, which
leaves every value as it is); without one, each function is the plain
single-process reduction it replaces, so a run without a group computes
exactly what it computed before this module. A decision's reduction
gathers the whole batch's values to every process and reduces them as one
process does (the batch is small: one value, or one residual row, per
sample), so it reads the same bits as one process on the same per-sample
values: at rho_max 1e8 a rounding-size change of a residual norm can
move the Newton exit by a step, and with it the whole step (config #4's
f64 step moves its gradient by 5% when only the CPU's thread count
changes). Only `all_reduce` is used, since gloo has no other collective on
CUDA tensors: a gather is an all-reduce of zero-padded slots, exact
(x + 0 = x). Every process must call the same reductions in the same
order, which holds because their results, and so the decisions that read
them, are equal on every process.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import torch
import torch.distributed as dist


def active() -> bool:
    """Whether a process group is initialised: the reductions are global."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def global_norm(t: torch.Tensor) -> torch.Tensor:
    """The 2-norm of a (bsz, ...) tensor over every process's shard."""
    if not active():
        return torch.linalg.vector_norm(t)
    return torch.linalg.vector_norm(gather_batch(t))


def all_true(flag: torch.Tensor) -> bool:
    """Whether a 0-dim boolean holds on every process (one host read)."""
    if not active():
        return bool(flag)
    t = flag.to(torch.int32).reshape(1)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t[0])


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of a (bsz,) tensor over the whole batch."""
    if not active():
        return torch.mean(t)
    return torch.mean(gather_batch(t))


def amax(t: torch.Tensor) -> torch.Tensor:
    """The largest entry of `t` over every process's shard."""
    if not active():
        return torch.amax(t)
    m = torch.amax(t).clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    return m


def row_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over dim 0 of a (rows, C) tensor whose rows are this
    process's share of the batch (sample-major), over every process's rows."""
    if not active():
        return t.mean(dim=0)
    return gather_batch(t).mean(dim=0)


def gather_batch(t: torch.Tensor) -> torch.Tensor:
    """Every process's `t` (equal shapes) concatenated along dim 0 in rank
    order: an all-reduce of zero-padded slots."""
    if not active():
        return t
    n, r = world_size(), rank()
    slots = torch.zeros((n, *t.shape), dtype=t.dtype, device=t.device)
    slots[r] = t
    dist.all_reduce(slots, op=dist.ReduceOp.SUM)
    return slots.reshape(n * t.shape[0], *t.shape[1:])


def average_(tensors: List[torch.Tensor]) -> None:
    """Replace each tensor (of one dtype) by its mean over the processes, in
    place, in one all-reduce."""
    if not active() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= world_size()
    for t, v in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient by its mean over the processes. The loss is a
    batch mean over equal shards, so the mean of the local gradients is the
    global batch's gradient. Every process holds the same model on the same
    path, so the same parameters have gradients."""
    average_([p.grad for p in params if p.grad is not None])


def average_scalars(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each tensor (batch means: the loss and what is logged beside it)
    averaged over the processes, in one all-reduce."""
    if not active() or not values:
        return values
    keys = list(values)
    flat = torch.cat([values[k].detach().reshape(-1).to(torch.float64) for k in keys])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= world_size()
    parts: List[torch.Tensor] = list(torch.split(flat, [values[k].numel() for k in keys]))
    return {k: v.view_as(values[k]).to(values[k].dtype) for k, v in zip(keys, parts)}
