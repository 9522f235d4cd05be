"""Tracking MPC adapter: network reference -> quadratic tracking cost
-> AL solver.

Port of `TrackingMPC.__init__`, `init_state`, `compute_pf` and
`__call__` (`deqmpc_tpu/policies/tracking_mpc.py:27-185`) for the
cold-start AL path: the diagonal cost Q = diag([Qlqr, Rlqr]) per knot
point, the linear term p = -Q * xu_ref and the constant
f = 0.5 xu_ref'Q xu_ref. The q-scaling, auxiliary-cost, interior-point,
linearize-once and cost-refresh options wait for later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from ..solvers import ALMPC, ALState, QuadCost


class TrackingMPC:
    def __init__(self, env, T: int, al_iter: int = 2, dtype=torch.float32,
                 max_newton_steps: int = 4, rho_max: float = 1e8,
                 dyn_res_tol: float = 1e-3, device="cuda"):
        self.env = env
        self.nx, self.nu, self.T = env.nx, env.nu, T
        self.dtype = dtype
        self.Q0 = torch.as_tensor(
            np.concatenate([np.asarray(env.Qlqr), np.asarray(env.Rlqr)]),
            dtype=dtype, device=device)

        def dyn_jac(x, u):
            xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
            return xn, torch.cat([Jx, Ju], dim=-1)

        self.ctrl = ALMPC(
            self.nx, self.nu, T,
            u_lower=env.action_space.low, u_upper=env.action_space.high,
            dyn=env.dynamics, dyn_jac=dyn_jac, al_iter=al_iter, dtype=dtype,
            max_newton_steps=max_newton_steps, rho_max=rho_max,
            dyn_res_tol=dyn_res_tol, device=device,
        )

    def init_state(self, bsz: int) -> ALState:
        return self.ctrl.init_state(bsz)

    def compute_pf(self, xu_ref, Q):
        """p = -Q*xu_ref (diagonal Q), f = 0.5 xu_ref'Q xu_ref."""
        return -Q * xu_ref, 0.5 * torch.sum(xu_ref * Q * xu_ref, dim=-1)

    def __call__(self, x0, x_ref, u_ref, state: ALState, al_iters: int = 2):
        """Returns (nominal_states, nominal_actions, status, new_state),
        states and actions cast back to the network dtype."""
        bsz = x0.shape[0]
        net_dtype = x_ref.dtype
        xu_ref = torch.cat([x_ref, u_ref], dim=-1).to(self.dtype)
        Q = self.Q0.expand(bsz, self.T, self.nx + self.nu)
        p, f = self.compute_pf(xu_ref, Q)
        x, u, status, new_state = self.ctrl.solve(
            x0, QuadCost(Q=Q, q=p, f=f), state, x_ref, u_ref, al_iter=al_iters)
        return x.to(net_dtype), u.to(net_dtype), status, new_state
