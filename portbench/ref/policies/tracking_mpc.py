"""Tracking MPC adapter: network reference -> quadratic tracking cost
-> AL solve (`deqmpc_tpu/policies/tracking_mpc.py`), cold or carried from
the round before. The diagonal cost is Q = diag([Qlqr, Rlqr]) per knot
point and the linear term q = -Q * xu_ref.
"""
from __future__ import annotations

import numpy as np
import torch

from ..solvers import ALMPC, ALState, QuadCost


class TrackingMPC:
    def __init__(self, env, T: int, al_iter: int = 2, dtype=torch.float32,
                 max_newton_steps: int = 4, rho_max: float = 1e8,
                 dyn_res_tol: float = 1e-3, device="cuda"):
        self.nx, self.nu, self.T = env.nx, env.nu, T
        self.dtype = dtype
        self.Q0 = torch.as_tensor(np.concatenate([np.asarray(env.Qlqr), np.asarray(env.Rlqr)]),
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

    def __call__(self, x0, x_ref, u_ref, state: ALState, al_iters: int = 2):
        """Returns (nominal_states, nominal_actions, new_state), states and
        actions cast back to the network dtype."""
        net_dtype = x_ref.dtype
        xu_ref = torch.cat([x_ref, u_ref], dim=-1).to(self.dtype)
        Q = self.Q0.expand(x0.shape[0], self.T, self.nx + self.nu)
        cost = QuadCost(Q=Q, q=-Q * xu_ref)
        x, u, new_state = self.ctrl.solve(x0, cost, state, x_ref, u_ref, al_iter=al_iters)
        return x.to(net_dtype), u.to(net_dtype), new_state
