"""Batched augmented-Lagrangian MPC solver: the outer AL loop.

Port of `ALMPC.__init__`, `init_state` and `solve`
(`deqmpc_tpu/solvers/al_mpc.py:64-322`) for the cold-start path of
serving and training: each AL iteration runs NewtonAL from the current
iterate, then updates the duals (inequality duals clamped at 0) and
multiplies the penalty by 10 up to `rho_max`.

The gradient is cut where the JAX package cuts it (`al_mpc.py:247-248,
262,271,315`): the starting trajectory, every Newton input iterate, the
iterate of the dual/penalty update and the returned state's x and u are
detached. So only the last AL iteration's Newton call receives a
cotangent, through its implicit backward into the cost (Q, q). The
streaming, linearize-once, cost-refresh, history and obstacle options
wait for later slices.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import resolve_device
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
        self.n = nx + nu
        self.dtype = dtype
        self.device = resolve_device(device)
        self.al_iter = al_iter
        self.rho_max = rho_max
        kw = dict(dtype=dtype, device=self.device)
        self.u_lower = torch.as_tensor(u_lower, **kw)
        self.u_upper = torch.as_tensor(u_upper, **kw)
        self.ncon = num_constraints(T, nx, nu)
        self.dyn = dyn
        self.dyn_jac = dyn_jac
        cfg = NewtonALConfig(nx=nx, nu=nu, T=T, max_newton_steps=max_newton_steps,
                             dyn_res_tol=dyn_res_tol)
        self.newton = NewtonAL(cfg, dyn, dyn_jac, self.u_lower, self.u_upper)

    def init_state(self, bsz: int) -> ALState:
        """Fresh solver state (`al_mpc.py:147-149`)."""
        return ALState.init(bsz, self.T, self.nx, self.nu, self.ncon,
                            self.dtype, self.device)

    def solve(self, x0, cost: QuadCost, state: ALState, x_init, u_init,
              al_iter: Optional[int] = None):
        """Run the AL loop. Returns (x, u, status, new_state).

        x_init/u_init: the starting trajectory where the state holds no
        primal iterate yet (the tracking adapter passes the network
        reference)."""
        al_iter = self.al_iter if al_iter is None else al_iter
        nx, dtype = self.nx, self.dtype
        x0 = x0.to(dtype)
        Q = cost.Q.to(dtype)
        q = cost.q.to(dtype)
        bsz = x0.shape[0]
        has = state.has_init[:, None, None]
        x = torch.where(has, state.x, x_init.detach().to(dtype))
        u = torch.where(has, state.u, u_init.detach().to(dtype))
        lam, rho = state.lam, state.rho
        xu = torch.cat([x, u], dim=-1)
        neq = self.T * nx
        for _ in range(al_iter):
            xu, _ = self.newton(xu.detach(), x0, lam, rho, Q, q)
            # the dual / penalty update takes no gradient (`al_mpc.py:269-271`)
            xu_sg = xu.detach()
            res, _ = full_residuals(self.dyn, xu_sg[..., :nx], xu_sg[..., nx:], x0,
                                    self.u_lower, self.u_upper)
            lam_next = lam + rho * res
            lam = torch.cat([lam_next[:, :neq], torch.clamp(lam_next[:, neq:], min=0.0)],
                            dim=1)
            # cap the penalty: in f32 an uncapped rho overflows the merit
            rho = torch.clamp(rho * 10.0, max=self.rho_max)
        x, u = xu[..., :nx], xu[..., nx:]
        new_state = ALState(lam=lam, rho=rho, x=x.detach(), u=u.detach(),
                            has_init=torch.ones((bsz,), dtype=torch.bool, device=x0.device))
        return x, u, torch.zeros((bsz,), dtype=torch.bool, device=x0.device), new_state
