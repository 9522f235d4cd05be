"""Solver utilities: rollouts, trajectory costs and a gradient checker.

Port of `deqmpc_tpu/solvers/util.py`: `get_traj` rolls controls through
linear(ised) dynamics (`LinDx`) or a dynamics callable, `get_cost` sums
the diagonal-quadratic cost over a trajectory, and `check_fd_grads` holds
`torch.autograd.grad` of a scalar function against central finite
differences (JAX's checker uses `jax.grad`).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .types import LinDx, QuadCost


def get_traj(T: int, u: torch.Tensor, x_init: torch.Tensor, dynamics) -> torch.Tensor:
    """x (bsz, T, nx) from x_init (bsz, nx) under the controls u (bsz, T, nu);
    u's last knot is not applied."""
    xs = [x_init]
    for t in range(T - 1):
        if isinstance(dynamics, LinDx):
            xu = torch.cat([xs[-1], u[:, t]], dim=-1)
            xs.append(torch.einsum("bij,bj->bi", dynamics.F[:, t], xu) + dynamics.f[:, t])
        else:
            xs.append(dynamics(xs[-1], u[:, t]))
    return torch.stack(xs, dim=1)


def get_cost(T: int, u: torch.Tensor, cost: QuadCost, dynamics=None,
             x_init: Optional[torch.Tensor] = None,
             x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per sample, sum_t 0.5 xu' diag(Q_t) xu + q_t' xu (the constant f
    left out, as in JAX); x rolled out from x_init when not given."""
    if x is None:
        x = get_traj(T, u, x_init, dynamics)
    xu = torch.cat([x, u], dim=-1)
    c = 0.5 * torch.sum(xu * cost.Q * xu, dim=-1) + torch.sum(cost.q * xu, dim=-1)
    return torch.sum(c, dim=-1)


def check_fd_grads(f: Callable, x: torch.Tensor, eps: float = 1e-5, rtol: float = 1e-3,
                   atol: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of the scalar f at x by autograd and by central
    differences, one entry at a time; raises AssertionError where they
    differ beyond (rtol, atol). Returns (g, g_fd)."""
    xg = x.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(xg), xg)
    g_fd = np.zeros(tuple(x.shape), dtype=np.float64)
    with torch.no_grad():
        for idx in np.ndindex(*x.shape):
            dx = torch.zeros_like(x)
            dx[idx] = eps
            g_fd[idx] = (float(f(x + dx)) - float(f(x - dx))) / (2 * eps)
    np.testing.assert_allclose(g.detach().cpu().numpy(), g_fd, rtol=rtol, atol=atol)
    return g, torch.as_tensor(g_fd)
