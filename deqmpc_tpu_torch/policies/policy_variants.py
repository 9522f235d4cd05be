"""DEQ-MPC policy variants.

Port of `deqmpc_tpu/policies/policy_variants.py:32-270`:

- `DEQMPCPolicyMem` (`--policy_variant mem`, `--addmem`): `DEQLayerMem`,
  the memory stream starting at zero.
- `DEQMPCPolicyDelta`: `DEQLayerDelta`; the trainer updates its `scales`
  by an EMA after each step (`is_delta`).
- `DEQMPCPolicyHistory`: an H-step observation history in (bsz, H, nx),
  or (bsz, nx) at H = 1; `DEQLayerHistoryState`, or `DEQLayerHistory`
  (joint states and actions, mlp) at `deq_out_type` 2.
- `DEQMPCPolicyHistoryEstPred`: the history and its actions in; each round
  a second `TrackingMPC` of horizon H in state-estimator (MHE) mode
  refines the estimated history before the tracking solve. Its Newton
  steps count into the policy's solver counts. No streaming carry
  (`carry` None), as in JAX. H must be at least 2: at H = 1 the
  estimator has no defect row, its residuals are empty beside its T*nx
  duals, and the JAX solve fails on the shapes; the port refuses it when
  the policy is built.
- `DEQMPCPolicyFeedback`: `DEQLayerFeedback`, fed the solver's and the
  network's trajectories.
- `DEQMPCPolicyQ`: `DEQLayerQ`; each tracking solve takes the round's Q
  scalings. As in JAX, the next round reads the network's own trajectory,
  not the solver's, and the carry is not shifted.

The loops of estpred and Q are their own: they report `deq_stats` and, as
JAX's, ignore `recompute_Qq`; the other variants take the base loop, the
cost refresh included.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.deq_layer_variants import (DEQLayerDelta, DEQLayerFeedback, DEQLayerHistory,
                                         DEQLayerHistoryState, DEQLayerHistoryStateEstPred,
                                         DEQLayerMem, DEQLayerQ)
from .deqmpc_policy import DEQMPCPolicy, PolicyCarry, PolicyConfig, deq_stats
from .tracking_mpc import TrackingMPC


class DEQMPCPolicyMem(DEQMPCPolicy):
    def _make_model(self, mcfg):
        return DEQLayerMem(mcfg)

    def _cold_aux(self, x_t) -> Dict:
        aux = super()._cold_aux(x_t)
        mem = self.model.init_mem(x_t.shape[0], x_t.dtype, x_t.device)
        return {**aux, "mem": mem, "old_mem": mem}


class DEQMPCPolicyDelta(DEQMPCPolicy):
    is_delta = True

    def _make_model(self, mcfg):
        return DEQLayerDelta(mcfg)


class DEQMPCPolicyFeedback(DEQMPCPolicy):
    def _make_model(self, mcfg):
        return DEQLayerFeedback(mcfg)

    def _cold_aux(self, x_t) -> Dict:
        aux = super()._cold_aux(x_t)
        return {**aux, "xn": aux["x"]}


class DEQMPCPolicyHistory(DEQMPCPolicy):
    takes_history = True

    def __init__(self, cfg: PolicyConfig, env, H: int = 1, device="cuda", obstacles=None):
        self.H = H
        super().__init__(cfg, env, device=device, obstacles=obstacles)

    def _make_model(self, mcfg):
        if self.cfg.deq_out_type == 2:
            return DEQLayerHistory(mcfg, H=self.H)
        return DEQLayerHistoryState(mcfg, H=self.H)

    def _history(self, obs_hist):
        return obs_hist.reshape(obs_hist.shape[0], self.H, self.nx)

    def forward(self, obs_hist, qp_solve: Optional[bool] = None,
                lastqp_solve: Optional[bool] = None) -> Dict:
        obs_hist = self._history(obs_hist)
        aux = self._cold_aux(obs_hist[:, -1])
        policy_out = self._deqmpc_iter(obs_hist, aux,
                                       self.tracking_mpc.init_state(obs_hist.shape[0]),
                                       *self._mode(qp_solve, lastqp_solve))
        policy_out["init_states"] = aux["x"]
        return policy_out


class DEQMPCPolicyHistoryEstPred(DEQMPCPolicyHistory):
    takes_action_history = True

    def __init__(self, cfg: PolicyConfig, env, H: int = 1, device="cuda", obstacles=None):
        if H < 2:
            raise ValueError(f"policy_variant estpred needs H >= 2 (got {H}): the estimator "
                             "of a one-knot history has no dynamics row to solve")
        super().__init__(cfg, env, H=H, device=device, obstacles=obstacles)
        self.state_estimator = TrackingMPC(
            env, H, al_iter=cfg.al_iter, state_estimator=True, dtype=cfg.solver_dtype,
            max_newton_steps=cfg.max_newton_steps, rho_max=cfg.rho_max,
            dyn_res_tol=cfg.dyn_res_tol, device=self.device)
        # one set of solver counts for the policy: the estimator's steps,
        # retries and backward solves count with the tracking solver's
        self.state_estimator.ctrl.newton.counts = self.newton_solver.counts

    def _make_model(self, mcfg):
        if self.cfg.deq_out_type == 2:
            return DEQLayerHistory(mcfg, H=self.H)
        return DEQLayerHistoryStateEstPred(mcfg, H=self.H)

    def forward(self, obs_hist, u_hist, qp_solve: Optional[bool] = None,
                lastqp_solve: Optional[bool] = None) -> Dict:
        """obs_hist (bsz, H, nx), u_hist (bsz, H, nu): the history window's
        actions, which the estimator tracks
        (`policy_variants.py:124-187`). Returns {"trajs", "nominal_x_ests"
        [(the network's estimate, the estimator's)] per round, "status",
        "init_states", "carry": None}."""
        cfg = self.cfg
        qp_solve, lastqp_solve = self._mode(qp_solve, lastqp_solve)
        obs_hist = self._history(obs_hist)
        bsz = obs_hist.shape[0]
        aux = {**self._cold_aux(obs_hist[:, -1]), "x_est": obs_hist}
        x_init = aux["x"]
        sol_state = self.tracking_mpc.init_state(bsz)
        est_state = self.state_estimator.init_state(bsz)
        trajs, x_ests, auxes = [], [], []
        status = torch.zeros((bsz,), dtype=torch.bool, device=obs_hist.device)
        for i in range(self.deq_iter):
            out_mpc, aux = self.model.step(obs_hist, {**aux, "iter": i})
            x_t, x_ref, u_ref = out_mpc["x_t"], out_mpc["x_ref"], out_mpc["u_ref"]
            x_est = aux["x_est"]
            ns, na, ns_est = x_ref, u_ref, x_est
            if qp_solve:
                # the MHE refinement of the estimated history
                ns_est, _, _, est_state = self.state_estimator(x_est[:, 0], x_est, u_hist,
                                                               est_state, al_iters=cfg.al_iter)
                ns, na, status, sol_state = self.tracking_mpc(x_t, x_ref, u_ref, sol_state,
                                                              al_iters=cfg.al_iter)
                aux = {**aux, "x": ns, "u": na, "x_est": ns_est}
            x_ests.append((x_est, ns_est))
            trajs.append((x_ref, ns, na))
            auxes.append(aux)
        if lastqp_solve:
            ns, na, status, sol_state = self.tracking_mpc(x_t, x_ref, u_ref, sol_state,
                                                          al_iters=10)
            trajs[-1] = (x_ref, ns, na)
        return {"trajs": trajs, "nominal_x_ests": x_ests, "status": status,
                "init_states": x_init, "carry": None, **deq_stats(auxes)}


class DEQMPCPolicyQ(DEQMPCPolicy):
    def _make_model(self, mcfg):
        return DEQLayerQ(mcfg)

    def forward(self, obs, qp_solve: Optional[bool] = None,
                lastqp_solve: Optional[bool] = None) -> Dict:
        """(`policy_variants.py:212-270`) Also returns "q_scaling", the
        rounds' (bsz, T) scalings, which the loss pulls towards 0."""
        cfg = self.cfg
        qp_solve, lastqp_solve = self._mode(qp_solve, lastqp_solve)
        bsz = obs.shape[0]
        aux = {**self._cold_aux(obs), "q": torch.ones((bsz, self.T), dtype=obs.dtype,
                                                      device=obs.device)}
        x_init = aux["x"]
        sol_state = self.tracking_mpc.init_state(bsz)
        trajs, q_scalings, auxes = [], [], []
        status = torch.zeros((bsz,), dtype=torch.bool, device=obs.device)
        for i in range(self.deq_iter):
            out_mpc, aux = self.model.step(obs, {**aux, "iter": i})
            x_t, x_ref, u_ref = out_mpc["x_t"], out_mpc["x_ref"], out_mpc["u_ref"]
            ns, na = x_ref, u_ref
            if qp_solve:
                # the next round still reads the network's trajectory, as in JAX
                ns, na, status, sol_state = self.tracking_mpc(
                    x_t, x_ref, u_ref, sol_state, al_iters=cfg.al_iter, q_scaling=out_mpc["q"])
            q_scalings.append(out_mpc["q"])
            trajs.append((x_ref, ns, na))
            auxes.append(aux)
        if lastqp_solve:
            ns, na, status, sol_state = self.tracking_mpc(x_t, x_ref, u_ref, sol_state,
                                                          al_iters=10)
            trajs[-1] = (x_ref, ns, na)
        carry = PolicyCarry(z=aux["z"].detach(), x=aux["x"].detach(), u=aux["u"].detach(),
                            solver=sol_state)
        return {"trajs": trajs, "q_scaling": q_scalings, "status": status,
                "init_states": x_init, "carry": carry, **deq_stats(auxes)}
