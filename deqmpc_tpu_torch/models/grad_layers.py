"""Custom-gradient utility layers for DEQ training.

Port of `grad_norm`, `jac_loss_estimate` and `update_scales`
(`deqmpc_tpu/models/grad_layers.py:32-107`):

- `grad_norm`: identity forward; its backward rescales the cotangent so
  that every last-dim channel carries the same mean magnitude (the JAX
  `custom_vjp` as a `torch.autograd.Function`).
- `jac_loss_estimate`: the Hutchinson estimate of tr(J'J) / numel(z0) for
  J = df/dz at z0, from Gaussian probe vectors drawn from a
  `torch.Generator` or given by the caller.
- `update_scales`: the EMA of the per-iteration median errors into the
  Delta layer's `scales`; returns the new scales. The median over the
  batch is the mean of the two middle values at an even batch, as
  `jnp.median` takes it (`torch.median` would return the lower one).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..parallel import collectives


class _GradNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        gf = g.reshape(-1, g.shape[-1])
        ch = collectives.row_mean(gf.abs())          # per-channel abs-mean, whole batch
        scale = ch.mean() / (ch + 1e-12)
        return (gf * scale[None]).reshape(g.shape)


def grad_norm(x):
    """Identity forward; the backward equalises the channels' mean gradient
    magnitude (`grad_layers.py:32-55`)."""
    return _GradNorm.apply(x)


def jac_loss_estimate(f: Callable, z0, vecs: int = 2,
                      generator: Optional[torch.Generator] = None, probes=None):
    """Hutchinson estimate of tr(J'J) / numel(z0), J = df/dz at z0
    (`grad_layers.py:58-77`): sum over probes v of ||v'J||^2, over
    `vecs` and numel(z0). The probes (vecs, *z0.shape) are `probes` when
    given, else standard normal draws from `generator` (made on the CPU,
    then moved to z0's device). Differentiable in f's parameters."""
    z = z0.detach().requires_grad_()
    with torch.enable_grad():
        fz = f(z)
    if probes is None:
        probes = torch.randn((vecs, *z0.shape), generator=generator, dtype=z0.dtype)
    probes = probes.to(z0.device, z0.dtype)
    total = 0.0
    for v in probes:
        (vJ,) = torch.autograd.grad(fz, z, v, retain_graph=True, create_graph=True)
        total = total + torch.sum(vJ * vJ)
    return total / probes.shape[0] / z0.numel()


def _median(a):
    """Median over dim 0, the mean of the two middle values at an even count
    (`jnp.median`'s midpoint)."""
    return torch.quantile(a, 0.5, dim=0, interpolation="midpoint")


def update_scales(scales, trajs: Sequence, gt_out, init_states, gamma: float = 0.98):
    """EMA update of the Delta layer's per-iteration output scales
    (`grad_layers.py:80-107`). scales (deq_iter, T-1, nx); trajs: the
    per-round trajectories (bsz, T, nx) (the optimizer's, as the trainer
    passes them); gt_out: the expert trajectory; init_states: the tiled
    initial state. Scale 0 tracks the median |gt - init|, scale i+1 the
    median error of round i; the rest keep their values."""
    n = scales.shape[0]
    gather = collectives.gather_batch  # the medians are over the whole batch
    new = [scales[0] * gamma
           + (1 - gamma) * _median(gather((gt_out[:, 1:] - init_states[:, 1:]).abs()))]
    for i, traj in enumerate(list(trajs)[:-1]):
        if i >= n - 1:
            break
        err = _median(gather((traj[:, 1:] - gt_out[:, 1:]).abs()))
        new.append(scales[i + 1] * gamma + (1 - gamma) * err)
    return torch.cat([torch.stack(new), scales[len(new):]], dim=0)
