"""Solver data types (port of `deqmpc_tpu/solvers/types.py` and of
`NewtonALConfig`, `deqmpc_tpu/solvers/newton_al.py:40-56`).

State is an explicit value threaded through the solver, as in the
JAX package: nothing is kept on the solver objects between solves.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class QuadCost(NamedTuple):
    """Diagonal-quadratic trajectory cost:
    sum_t 0.5 xu' diag(Q_t) xu + q_t' xu + f_t.
    Q: (bsz, T, n) diagonal entries; q: (bsz, T, n); f: (bsz, T)."""

    Q: torch.Tensor
    q: torch.Tensor
    f: torch.Tensor


class ALState(NamedTuple):
    """Per-sample augmented-Lagrangian solver state.

    lam: (bsz, ncon) duals [eq block first, then ineq];
    rho: (bsz, 1) penalty weight;
    x: (bsz, T, nx) and u: (bsz, T, nu) primal warm start;
    has_init: (bsz,) bool, whether x/u hold a valid warm start."""

    lam: torch.Tensor
    rho: torch.Tensor
    x: torch.Tensor
    u: torch.Tensor
    has_init: torch.Tensor

    @staticmethod
    def init(bsz: int, T: int, nx: int, nu: int, ncon: int,
             dtype=torch.float32, device="cuda") -> "ALState":
        kw = dict(dtype=dtype, device=device)
        return ALState(
            lam=torch.zeros((bsz, ncon), **kw),
            rho=torch.ones((bsz, 1), **kw),
            x=torch.zeros((bsz, T, nx), **kw),
            u=torch.zeros((bsz, T, nu), **kw),
            has_init=torch.zeros((bsz,), dtype=torch.bool, device=device),
        )


@dataclasses.dataclass(frozen=True)
class NewtonALConfig:
    nx: int
    nu: int
    T: int
    max_newton_steps: int = 4
    n_ls: int = 20
    fallback_jitter: float = 1e-4
    dyn_res_tol: float = 1e-3
    min_stepsz: float = 1e-8
