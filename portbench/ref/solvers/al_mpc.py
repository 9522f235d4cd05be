"""Batched augmented-Lagrangian MPC solver: the outer AL loop
(`deqmpc_tpu/solvers/al_mpc.py`), cold or carried from the round before,
without streaming: each AL iteration runs NewtonAL from the current
iterate, then updates the duals (inequality duals clamped at 0) and
multiplies the penalty by 10 up to `rho_max`.
"""
from __future__ import annotations

from typing import Callable

import torch

from .al_core import full_residuals, num_constraints
from .newton_al import NewtonAL
from .types import ALState, NewtonALConfig, QuadCost


class ALMPC:
    """Batched AL trajectory optimizer.

    dyn(x, u): (..., nx), (..., nu) -> (..., nx)
    dyn_jac(x, u): -> (x_next, F) with F = [A|B] (..., nx, nx+nu)"""

    def __init__(self, nx: int, nu: int, T: int, u_lower, u_upper,
                 dyn: Callable, dyn_jac: Callable, al_iter: int = 2, rho_max: float = 1e8,
                 max_newton_steps: int = 4, dyn_res_tol: float = 1e-3,
                 dtype=torch.float32, device="cuda"):
        self.nx, self.nu, self.T = nx, nu, T
        self.dtype = dtype
        self.device = torch.device(device)
        self.al_iter = al_iter
        self.rho_max = rho_max
        kw = dict(dtype=dtype, device=self.device)
        self.u_lower = torch.as_tensor(u_lower, **kw)
        self.u_upper = torch.as_tensor(u_upper, **kw)
        self.ncon = num_constraints(T, nx, nu)
        self.dyn = dyn
        cfg = NewtonALConfig(nx=nx, nu=nu, T=T, max_newton_steps=max_newton_steps,
                             dyn_res_tol=dyn_res_tol)
        self.newton = NewtonAL(cfg, dyn, dyn_jac, self.u_lower, self.u_upper)

    def init_state(self, bsz: int) -> ALState:
        return ALState.init(bsz, self.T, self.nx, self.nu, self.ncon, self.dtype, self.device)

    def solve(self, x0, cost: QuadCost, state: ALState, x_init, u_init, al_iter=None):
        """Run the AL loop from the state's iterate, or from (x_init, u_init)
        where the state holds none yet. Returns (x, u, new_state)."""
        al_iter = self.al_iter if al_iter is None else al_iter
        nx, dtype, neq = self.nx, self.dtype, self.T * self.nx
        x0 = x0.to(dtype)
        Q = cost.Q.to(dtype)
        q = cost.q.to(dtype)
        has = state.has_init[:, None, None]
        x = torch.where(has, state.x, x_init.detach().to(dtype))
        u = torch.where(has, state.u, u_init.detach().to(dtype))
        lam, rho = state.lam, state.rho
        xu = torch.cat([x, u], dim=-1)
        for _ in range(al_iter):
            xu = self.newton(xu.detach(), x0, lam, rho, Q, q)
            res, _ = full_residuals(self.dyn, xu[..., :nx], xu[..., nx:], x0,
                                    self.u_lower, self.u_upper)
            lam_next = lam + rho * res
            lam = torch.cat([lam_next[:, :neq], torch.clamp(lam_next[:, neq:], min=0.0)],
                            dim=1)
            # cap the penalty: in f32 an uncapped rho overflows the merit
            rho = torch.clamp(rho * 10.0, max=self.rho_max)
        x, u = xu[..., :nx], xu[..., nx:]
        new_state = ALState(lam=lam, rho=rho, x=x.detach(), u=u.detach(),
                            has_init=torch.ones((x.shape[0],), dtype=torch.bool,
                                                device=xu.device))
        return x, u, new_state
