"""Batched augmented-Lagrangian MPC solver: the outer AL loop.

Port of `warm_start_al`, `warm_start_al_stream` and `ALMPC`
(`deqmpc_tpu/solvers/al_mpc.py:32-387`): each AL iteration runs NewtonAL
from the current iterate, then updates the duals (inequality duals
clamped at 0) and multiplies the penalty by 10 up to `rho_max`.

Streaming (receding-horizon) mode: `warm_start_shift` shifts the
previous tick's iterate one knot, resets the duals and clamps rho;
`solve(streaming=True)` adds the rho-cap exit, which fires once the
*uncapped* update rho*10 exceeds rho_max anywhere in the batch and
freezes the iterate, duals and penalty for the rest of that call. As in
JAX, the exit is a mask (`torch.where` on a 0-dim bool tensor, no host
read): the frozen iterations' Newton calls still run.
`solve_linearize_once` freezes the dynamics Jacobians at the
warm-started iterate and runs its AL iterations on that linear model,
with a stall exit and a rho-cap exit of its own. The linearisation is
captured per call (`NewtonAL.with_dynamics`), never kept on the solver.

The gradient is cut where the JAX package cuts it (`al_mpc.py:247-248,
262,271,315`): the starting trajectory, every Newton input iterate, the
iterate of the dual/penalty update and the returned state's x and u are
detached. So only the last AL iteration's Newton call receives a
cotangent, through its implicit backward into the cost (Q, q); once the
rho-cap exit has fired, that cotangent is 0.

Obstacles (`ALMPC(obstacles=...)`, the whole field of spheres):
`select_obstacles(x_ref)` picks the `n_obs_sel` nearest per (sample,
step) and returns them; the caller passes that set to `solve(...,
obstacles=)`, which adds their rows to every Newton call and dual update
of the solve. Nothing is stored on the solver between calls.

The cost refresh (`solve(compute_Qq=...)`, `al_mpc.py:186-215,302-310`):
after the dual update of every AL iteration but the last, (Q, q) =
compute_Qq(xu) at the detached iterate, both detached and cast to the
solver's dtype; the next iteration's Newton call tracks that cost. So
under the refresh the last Newton call's implicit backward reaches the
refreshed cost, which carries no gradient: the round's network output
then gets none through the solve.

`kkt_residuals` (`al_mpc.py:388-400`) gives the per-sample norm of the
clamped residuals and the cost of a trajectory, for logs and tests.

`state_estimator=True` is the MHE flavour (`al_mpc.py:77-91`): no
initial-state row and no control box, in every Newton call, dual update
and implicit backward; the duals hold the T*nx eq rows (one of them a
zero row) and any obstacle rows.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import resolve_device
from ..parallel import collectives
from ..utils import profiling
from .al_core import ObstacleSet, compute_cost, full_residuals, num_constraints
from .newton_al import NewtonAL
from .types import ALState, LinDx, NewtonALConfig, QuadCost


def _first_below(cost_hist, cost_start):
    """Per sample, the first history index whose cost is below the start
    (index 0 when none is: jnp.argmax of an all-False column)."""
    below = (cost_hist < cost_start[None]).to(torch.int8)
    return torch.argmax(below, dim=0)


def _take_rho(rho, rho_hist, idx):
    flat = rho_hist.reshape(rho_hist.shape[0], -1)
    return torch.gather(flat, 0, idx[None, :]).reshape(rho.shape)


def warm_start_al(lam, rho, cost_start, cost_hist, lam_hist, rho_hist):
    """Cost-history warm start (`al_mpc.py:32-52`): per sample, take the
    first history entry whose cost is below the current start, rescale the
    duals to that entry's norm and restart rho from it. Shapes: lam
    (bsz, ncon), rho (bsz, 1), cost_hist (H, bsz), lam_hist (H, bsz, ncon),
    rho_hist (H, bsz, 1)."""
    idx = _first_below(cost_hist, cost_start)
    lam_sel = torch.gather(lam_hist, 0, idx[None, :, None].expand(1, *lam_hist.shape[1:]))[0]
    num = torch.linalg.vector_norm(lam_sel, dim=-1)
    den = torch.linalg.vector_norm(lam, dim=-1)
    return lam * (num / (den + 1e-30))[:, None], _take_rho(rho, rho_hist, idx)


def warm_start_al_stream(rho, cost_start, cost_hist, rho_hist):
    """Streaming flavour (`al_mpc.py:55-61`): restart rho only."""
    return _take_rho(rho, rho_hist, _first_below(cost_hist, cost_start))


class ALMPC:
    """Batched AL trajectory optimizer.

    dyn(x, u): (..., nx), (..., nu) -> (..., nx)
    dyn_jac(x, u): -> (x_next, F) with F = [A|B] (..., nx, nx+nu)
    obstacles: the field, an ObstacleSet with centers (N, 3), or None."""

    def __init__(self, nx: int, nu: int, T: int, u_lower, u_upper,
                 dyn: Callable, dyn_jac: Callable, al_iter: int = 2, rho_max: float = 1e8,
                 max_newton_steps: int = 4, dyn_res_tol: float = 1e-3,
                 obstacles: Optional[ObstacleSet] = None, n_obs_sel: int = 4,
                 state_estimator: bool = False, dtype=torch.float32, device="cuda"):
        self.nx, self.nu, self.T = nx, nu, T
        self.n = nx + nu
        self.dtype = dtype
        self.device = resolve_device(device)
        self.al_iter = al_iter
        self.rho_max = rho_max
        kw = dict(dtype=dtype, device=self.device)
        self.state_estimator = state_estimator
        # the state estimator has no control box
        self.u_lower = None if state_estimator else torch.as_tensor(u_lower, **kw)
        self.u_upper = None if state_estimator else torch.as_tensor(u_upper, **kw)
        self.obstacles = None if obstacles is None else ObstacleSet(
            torch.as_tensor(obstacles.centers, **kw), float(obstacles.radius))
        self.n_obs_sel = n_obs_sel if obstacles is not None else 0
        self.ncon = num_constraints(T, nx, nu, self.n_obs_sel, has_u_box=not state_estimator)
        self.dyn = dyn
        self.dyn_jac = dyn_jac
        cfg = NewtonALConfig(nx=nx, nu=nu, T=T, max_newton_steps=max_newton_steps,
                             dyn_res_tol=dyn_res_tol, state_estimator=state_estimator)
        self.newton = NewtonAL(cfg, dyn, dyn_jac, self.u_lower, self.u_upper)

    def init_state(self, bsz: int) -> ALState:
        """Fresh solver state (`al_mpc.py:147-149`)."""
        return ALState.init(bsz, self.T, self.nx, self.nu, self.ncon,
                            self.dtype, self.device)

    def warm_start_shift(self, state: ALState, rho_init_max: float) -> ALState:
        """Receding-horizon shift (`al_mpc.py:151-170`): shift the duals one
        step, zero the tail, then multiply them by 0 as JAX does (a NaN dual
        stays NaN); clamp rho to rho_init_max; shift the primal iterate left
        one knot, repeating the last."""
        bsz, T, nx = state.lam.shape[0], self.T, self.nx
        lam_eq = state.lam[:, : T * nx].reshape(bsz, T, nx)
        lam_in = state.lam[:, T * nx:].reshape(bsz, T, -1)
        lam_eq = torch.cat([lam_eq[:, 1:-1], lam_eq[:, -2:] * 0], dim=1)
        lam_in = torch.cat([lam_in[:, 1:], lam_in[:, -1:] * 0], dim=1)
        lam = torch.cat([lam_eq.reshape(bsz, -1), lam_in.reshape(bsz, -1)], dim=1) * 0.0
        shift = lambda a: torch.cat([a[:, 1:], a[:, -1:]], dim=1)  # noqa: E731
        return ALState(lam=lam, rho=torch.clamp(state.rho, max=rho_init_max),
                       x=shift(state.x), u=shift(state.u),
                       has_init=torch.ones_like(state.has_init))

    def select_obstacles(self, x_ref) -> Optional[ObstacleSet]:
        """The `n_obs_sel` obstacles nearest to each knot of x_ref (bsz, T, >= 3),
        nearest first, as the JAX package's `lax.top_k` orders them
        (`al_mpc.py:172-183`); None without obstacles. Returns the set and
        stores nothing."""
        if self.obstacles is None:
            return None
        centers = self.obstacles.centers
        d2 = torch.sum((x_ref.detach()[..., None, :3] - centers) ** 2, dim=-1)  # (bsz, T, N)
        idx = torch.topk(-d2, self.n_obs_sel, dim=-1, largest=True, sorted=True).indices
        return ObstacleSet(centers[idx], self.obstacles.radius)

    def _check_obstacles(self, obstacles):
        if self.obstacles is not None and obstacles is None:
            raise ValueError("obstacle MPC: pass obstacles=select_obstacles(x_ref) to the solve")
        if self.obstacles is None and obstacles is not None:
            raise ValueError("obstacles passed to a solver built without obstacles")

    def _al_update(self, dyn, xu, x0, lam, rho, obs=None):
        """Residuals at the (detached) iterate, then the dual step (inequality
        and obstacle duals clamped at 0) and the uncapped penalty step."""
        with profiling.span("al.update"):
            nx, neq = self.nx, self.T * self.nx
            res, res_c = full_residuals(dyn, xu[..., :nx], xu[..., nx:], x0,
                                        self.u_lower, self.u_upper, obs, self.state_estimator)
            lam_next = lam + rho * res
            lam_next = torch.cat([lam_next[:, :neq], torch.clamp(lam_next[:, neq:], min=0.0)],
                                 dim=1)
            return lam_next, rho * 10.0, res_c

    def _result(self, xu, lam, rho, status):
        nx, bsz = self.nx, xu.shape[0]
        x, u = xu[..., :nx], xu[..., nx:]
        new_state = ALState(lam=lam, rho=rho, x=x.detach(), u=u.detach(),
                            has_init=torch.ones((bsz,), dtype=torch.bool, device=xu.device))
        return x, u, status, new_state

    def solve(self, x0, cost: QuadCost, state: ALState, x_init=None, u_init=None,
              al_iter: Optional[int] = None, streaming: bool = False,
              return_history: bool = False, obstacles: Optional[ObstacleSet] = None,
              compute_Qq: Optional[Callable] = None,
              warm_start_history: Optional[Tuple] = None):
        """Run the AL loop. Returns (x, u, status, new_state), and with
        `return_history` also the per-iteration (cost, lam, rho) stacks.

        x_init/u_init: the starting trajectory where the state holds no
        primal iterate yet (the tracking adapter passes the network
        reference). streaming: the rho-cap exit; status is then True on
        every sample once it fired, else False. warm_start_history: a
        (cost, lam, rho) history of an earlier solve, restarting the duals
        and penalty through `warm_start_al`. obstacles: the selected set
        (`select_obstacles`), required when the solver has obstacles.
        compute_Qq: xu -> (Q, q), the cost refresh between AL iterations
        (the history records each iteration's cost before its refresh)."""
        with profiling.span("al.solve"):
            self._check_obstacles(obstacles)
            al_iter = self.al_iter if al_iter is None else al_iter
            nx, dtype = self.nx, self.dtype
            x0 = x0.to(dtype)
            Q = cost.Q.to(dtype)
            q = cost.q.to(dtype)
            bsz = x0.shape[0]
            if x_init is None:
                x_init = x0[:, None].expand(bsz, self.T, nx)
            if u_init is None:
                u_init = torch.zeros((bsz, self.T, self.nu), dtype=dtype, device=x0.device)
            has = state.has_init[:, None, None]
            x = torch.where(has, state.x, x_init.detach().to(dtype))
            u = torch.where(has, state.u, u_init.detach().to(dtype))
            lam, rho = state.lam, state.rho
            xu = torch.cat([x, u], dim=-1)
            stopped = torch.zeros((), dtype=torch.bool, device=x0.device)
            if warm_start_history is not None:
                lam, rho = warm_start_al(lam, rho, compute_cost(xu.detach(), Q, q),
                                         *warm_start_history)
            hist = ([compute_cost(xu.detach(), Q, q)], [lam], [rho])
            for i in range(al_iter):
                xu_in = xu.detach()
                xu, _ = self.newton(xu_in, x0, lam, rho, Q, q, obstacles)
                if streaming:
                    # freeze the iterate once the rho-cap exit has fired
                    xu = torch.where(stopped, xu_in, xu)
                # the dual / penalty update takes no gradient (`al_mpc.py:269-271`)
                xu_sg = xu.detach()
                lam_next, rho_uncapped, _ = self._al_update(self.dyn, xu_sg, x0, lam, rho,
                                                            obstacles)
                # cap the penalty: in f32 an uncapped rho overflows the merit
                rho_next = torch.clamp(rho_uncapped, max=self.rho_max)
                if streaming:
                    lam = torch.where(stopped, lam, lam_next)
                    rho = torch.where(stopped, rho, rho_next)
                    # the exit tests the uncapped update (`al_mpc.py:286-296`):
                    # the capped rho never exceeds rho_max
                    stopped = stopped | (collectives.amax(rho_uncapped) > self.rho_max)
                else:
                    lam, rho = lam_next, rho_next
                for h, v in zip(hist, (compute_cost(xu_sg, Q, q), lam, rho)):
                    h.append(v)
                if compute_Qq is not None and i < al_iter - 1:
                    Q_new, q_new = compute_Qq(xu_sg)
                    Q, q = Q_new.detach().to(dtype), q_new.detach().to(dtype)
            status = (stopped.expand(bsz) if streaming
                      else torch.zeros((bsz,), dtype=torch.bool, device=x0.device))
            out = self._result(xu, lam, rho, status)
            if return_history:
                return (*out, tuple(torch.stack(h) for h in hist))
            return out

    def linearize(self, state: ALState) -> LinDx:
        """The dynamics linearised at the state's iterate (detached):
        x_{t+1} ~ F_t [x_t; u_t] + f_t (`al_mpc.py:340-345`)."""
        x, u = state.x, state.u
        x_next, F = self.dyn_jac(x[:, :-1], u[:, :-1])
        x_next, F = x_next.to(self.dtype), F.to(self.dtype)
        xu = torch.cat([x, u], dim=-1)[:, :-1]
        f = x_next - torch.einsum("btij,btj->bti", F, xu)
        return LinDx(F=F.detach(), f=f.detach())

    @staticmethod
    def linear_dynamics(lin: LinDx):
        """(dyn, dyn_jac) of the linear model `lin`. The line search calls
        dyn on n_ls stacked copies of the batch, so leading dims are folded
        onto F's (bsz, T-1)."""
        F, f = lin

        def dyn(x, u):
            xu = torch.cat([x, u], dim=-1)
            xu = xu.reshape(-1, *F.shape[:2], F.shape[-1])
            return (torch.einsum("...tij,...tj->...ti", F, xu) + f).reshape(x.shape)

        return dyn, lambda x, u: (dyn(x, u), F)

    def solve_linearize_once(self, x0, cost: QuadCost, state: ALState, num_iters: int = 8,
                             obstacles: Optional[ObstacleSet] = None):
        """Streaming 'linearize once' mode (`al_mpc.py:324-386`): freeze the
        Jacobians at the warm-started iterate and run `num_iters` AL
        iterations on the linear model, with two exits kept as JAX writes
        them: the stall exit (the batch's global ||res_c|| not below the
        best so far, starting from inf) and the rho-cap exit on the
        *capped* rho (`>=`). Returns (x, u, status, new_state)."""
        with profiling.span("al.solve"):
            self._check_obstacles(obstacles)
            dtype = self.dtype
            x0 = x0.to(dtype)
            Q = cost.Q.to(dtype)
            q = cost.q.to(dtype)
            lin_dyn, lin_dyn_jac = self.linear_dynamics(self.linearize(state))
            newton = self.newton.with_dynamics(lin_dyn, lin_dyn_jac)
            lam, rho = state.lam, state.rho
            xu = torch.cat([state.x, state.u], dim=-1)
            stopped = torch.zeros((), dtype=torch.bool, device=x0.device)
            prev_res = torch.tensor(float("inf"), dtype=dtype, device=x0.device)
            for _ in range(num_iters):
                xu_in = xu.detach()
                xu, _ = newton(xu_in, x0, lam, rho, Q, q, obstacles)
                xu = torch.where(stopped, xu_in, xu)
                lam_next, rho_uncapped, res_c = self._al_update(lin_dyn, xu.detach(), x0, lam, rho,
                                                                obstacles)
                lam = torch.where(stopped, lam, lam_next)
                rho = torch.where(stopped, rho, torch.clamp(rho_uncapped, max=self.rho_max))
                cur_res = collectives.global_norm(res_c)
                stopped = stopped | (cur_res >= prev_res) | (collectives.amax(rho) >= self.rho_max)
                prev_res = torch.minimum(prev_res, cur_res)
            return self._result(xu, lam, rho, stopped.expand(x0.shape[0]))

    # -- diagnostics ----------------------------------------------------------
    def kkt_residuals(self, x0, cost: QuadCost, x, u, obstacles: Optional[ObstacleSet] = None):
        """(||res_clamp|| per sample, cost per sample) of the trajectory
        (x, u) from x0; `obstacles`: the selected set, as `solve` takes it."""
        self._check_obstacles(obstacles)
        xu = torch.cat([x, u], dim=-1)
        _, res_c = full_residuals(self.dyn, x, u, x0, self.u_lower, self.u_upper, obstacles,
                                  self.state_estimator)
        return (torch.linalg.vector_norm(res_c, dim=-1),
                compute_cost(xu, cost.Q.to(xu.dtype), cost.q.to(xu.dtype)))
