"""Tracking MPC adapter: network reference -> quadratic tracking cost
-> AL solver.

Port of `TrackingMPC.__init__`, `init_state`, `warm_start_state`,
`compute_pf` and `__call__` (`deqmpc_tpu/policies/tracking_mpc.py:27-185`)
for the AL path, cold-started or streaming, and the interior-point path
(`solver_type="ip"`, `tracking_mpc.py:77-86,138-141`: `IPMPC` from the
network reference, the AL state handed back unchanged and status all
False). The diagonal cost is
Q = diag([Qlqr, Rlqr]) per knot point, the linear term p = -Q * xu_ref and
the constant f = 0.5 xu_ref'Q xu_ref. With `obstacles` (the field), each
call selects the `n_obs_sel` spheres nearest to the reference's knots,
from x_ref cast to the solver dtype, and hands them to the solve
(`tracking_mpc.py:142-143,183`). `q_scaling` (bsz, T), the Q variant's
per-knot scalings, scales the cost as Q * (q_scaling + 1)
(`tracking_mpc.py:118-128`). `state_estimator=True` is the MHE flavour
(`tracking_mpc.py:43-46`): Q = diag([Qlqr, 0]), a cost on the states
only, and the AL solve without the initial-state row or the control box.

`aux_cost=(aux_Q_diag, aux_x)` (`tracking_mpc.py:36,46-55`): a fixed
diagonal pull towards aux_x, its unmasked aux_Q added to Q and its linear
term aux_p = -aux_Q * aux_x, masked per sample by `q_mask`, added to p.
`model_call` (xu -> the network's refreshed (x_ref, u_ref) concatenated,
`tracking_mpc.py:144-164`) turns on the cost refresh between AL
iterations (`ALMPC.solve(compute_Qq=...)`): Q keeps its template, p
follows the fresh reference from the Q before the aux term, and the
masked aux pull is added again. The linearize-once streaming solve takes
no refresh, so the two together raise ValueError.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..solvers import ALMPC, IPMPC, ALState, ObstacleSet, QuadCost


class TrackingMPC:
    def __init__(self, env, T: int, al_iter: int = 2, state_estimator: bool = False,
                 dtype=torch.float32,
                 max_newton_steps: int = 4, rho_max: float = 1e8,
                 dyn_res_tol: float = 1e-3, obstacles: Optional[ObstacleSet] = None,
                 n_obs_sel: int = 4, solver_type: str = "al", qp_iter: int = 1,
                 ip_eps: float = 1e-2, ip_grad_method: str = "analytic", device="cuda",
                 aux_cost: Optional[Tuple] = None):
        if solver_type not in ("al", "ip"):
            raise ValueError(f"unknown solver_type {solver_type!r}")
        self.env = env
        self.solver_type = solver_type
        self.nx, self.nu, self.T = env.nx, env.nu, T
        self.dtype = dtype
        self.state_estimator = state_estimator
        R = np.zeros(env.nu) if state_estimator else np.asarray(env.Rlqr)
        self.Q0 = torch.as_tensor(np.concatenate([np.asarray(env.Qlqr), R]),
                                  dtype=dtype, device=device)
        self.aux_Q = self.aux_p = None
        if aux_cost is not None:
            aux_Q, aux_x = (torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
                            for a in aux_cost)
            self.aux_Q, self.aux_p = aux_Q, -(aux_Q * aux_x)

        def dyn_jac(x, u):
            xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
            return xn, torch.cat([Jx, Ju], dim=-1)

        self.ctrl = ALMPC(
            self.nx, self.nu, T,
            u_lower=env.action_space.low, u_upper=env.action_space.high,
            dyn=env.dynamics, dyn_jac=dyn_jac, al_iter=al_iter, dtype=dtype,
            max_newton_steps=max_newton_steps, rho_max=rho_max,
            dyn_res_tol=dyn_res_tol, obstacles=obstacles, n_obs_sel=n_obs_sel,
            state_estimator=state_estimator, device=device,
        )
        if solver_type == "ip":
            self.ip_ctrl = IPMPC(
                self.nx, self.nu, T,
                u_lower=env.action_space.low, u_upper=env.action_space.high,
                dyn=env.dynamics, dyn_jac=dyn_jac, qp_iter=qp_iter, dtype=dtype,
                eps=ip_eps, grad_method=ip_grad_method, device=device,
            )

    def init_state(self, bsz: int) -> ALState:
        return self.ctrl.init_state(bsz)

    def warm_start_state(self, state: ALState, rho_init_max: float) -> ALState:
        return self.ctrl.warm_start_shift(state, rho_init_max)

    def compute_pf(self, xu_ref, Q):
        """p = -Q*xu_ref (diagonal Q), f = 0.5 xu_ref'Q xu_ref."""
        return -Q * xu_ref, 0.5 * torch.sum(xu_ref * Q * xu_ref, dim=-1)

    def __call__(self, x0, x_ref, u_ref, state: ALState, al_iters: int = 2,
                 streaming: bool = False, linearize_once: bool = False, q_scaling=None,
                 q_mask=None, model_call: Optional[Callable] = None):
        """Returns (nominal_states, nominal_actions, status, new_state),
        states and actions cast back to the network dtype. streaming: the
        solve's rho-cap exit; with linearize_once too, the AL loop runs on
        the dynamics linearised once at the warm-started iterate, with a
        fixed budget of 8 iterations whose exits govern termination
        (`tracking_mpc.py:170-178`). With solver_type "ip" the SQP solve
        runs instead, from x_ref and u_ref, and neither option applies.
        q_scaling (bsz, T): Q * (q_scaling + 1), with its gradient. q_mask
        (bsz,): the aux pull's per-sample gate (default all on).
        model_call: the cost refresh (module docstring)."""
        bsz = x0.shape[0]
        net_dtype = x_ref.dtype
        xu_ref = torch.cat([x_ref, u_ref], dim=-1).to(self.dtype)
        Q_pre = self.Q0.expand(bsz, self.T, self.nx + self.nu)
        if q_scaling is not None:
            Q_pre = Q_pre * (q_scaling.to(self.dtype) + 1.0)[:, :, None]
        p, f = self.compute_pf(xu_ref, Q_pre)
        Q, aux_p_masked = Q_pre, None
        if self.aux_Q is not None:
            mask = (torch.ones((bsz,), dtype=self.dtype, device=x0.device) if q_mask is None
                    else q_mask.to(self.dtype))
            aux_p_masked = self.aux_p * mask[:, None, None]
            p, Q = p + aux_p_masked, Q + self.aux_Q
        cost = QuadCost(Q=Q, q=p, f=f)
        if self.solver_type == "ip":
            x, u = self.ip_ctrl.solve(x0, cost, x_init=x_ref, u_init=u_ref)
            status = torch.zeros((bsz,), dtype=torch.bool, device=x0.device)
            return x.to(net_dtype), u.to(net_dtype), status, state
        obs = self.ctrl.select_obstacles(x_ref.to(self.dtype))
        compute_Qq = None
        if model_call is not None:
            if linearize_once and streaming:
                raise ValueError("recompute_Qq is not supported on the linearize-once streaming "
                                 "path (the frozen-Jacobian solve takes no cost refresh); "
                                 "disable one of the two")

            def compute_Qq(xu):
                p_new, _ = self.compute_pf(model_call(xu).to(self.dtype), Q_pre)
                return Q, p_new if aux_p_masked is None else p_new + aux_p_masked

        if linearize_once and streaming:
            x, u, status, new_state = self.ctrl.solve_linearize_once(x0, cost, state,
                                                                     obstacles=obs)
        else:
            x, u, status, new_state = self.ctrl.solve(
                x0, cost, state, x_ref, u_ref, al_iter=al_iters, streaming=streaming,
                obstacles=obs, compute_Qq=compute_Qq)
        return x.to(net_dtype), u.to(net_dtype), status, new_state
