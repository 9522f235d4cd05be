"""NewtonAL: the inner Newton solver on the AL merit, forward only
(`deqmpc_tpu/solvers/newton_al.py`):

  * at most `max_newton_steps` Newton steps with the JAX `lax.while_loop`'s
    global exits (dyn-res stall or convergence, small step), read on the
    host once per Newton step;
  * the Newton system is solved by the plain block-tridiagonal solve;
  * a non-finite update anywhere in the batch retries the solve once with
    a strongly jittered diagonal;
  * the 20 step sizes 2^{0..-19} of the line search are evaluated in one
    batched merit call; NaN merits never win, and only improvements are
    accepted.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops.tridiag import block_tridiag_solve
from .al_core import full_residuals, merit_function, merit_grad_blocks
from .types import NewtonALConfig


class NewtonAL:
    """newton_al(xu, x0, lam, rho, Q, q) -> xu_out.

    dyn(x, u): batched discrete dynamics over leading dims.
    dyn_jac(x, u): -> (x_next, F) with F = [A B]: (..., nx, nx+nu)."""

    def __init__(self, cfg: NewtonALConfig, dyn: Callable, dyn_jac: Callable,
                 u_lower, u_upper):
        self.cfg = cfg
        self.dyn = dyn
        self.dyn_jac = dyn_jac
        self.u_lower = u_lower
        self.u_upper = u_upper

    def _merit(self, xu, Q, q, x0, lam, rho):
        return merit_function(self.dyn, xu, Q, q, x0, lam, rho, self.u_lower, self.u_upper)

    def _dyn_res_norm(self, xu, x0):
        """Norm of the clamped residuals over the whole batch: the exit
        rule is global, as in the JAX package."""
        nx = self.cfg.nx
        _, res_c = full_residuals(self.dyn, xu[..., :nx], xu[..., nx:], x0,
                                  self.u_lower, self.u_upper)
        return torch.linalg.vector_norm(res_c)

    def _assemble(self, xu, Q, q, x0, lam, rho):
        nx = self.cfg.nx
        x, u = xu[..., :nx], xu[..., nx:]
        x_next, F = self.dyn_jac(x[:, :-1], u[:, :-1])
        defects = x[:, 1:] - x_next
        last = (x[:, 0] - x0)[:, None]
        return merit_grad_blocks(xu, Q, q, x0, lam, rho, F, self.u_lower, self.u_upper,
                                 dyn_eq_res=torch.cat([defects, last], dim=1))

    def _solve_newton_system(self, g, D, O):
        """Solve H x = -g; retry once with a jittered diagonal when the
        result has a non-finite entry anywhere in the batch."""
        O, g = O.contiguous(), g.contiguous()
        upd = -block_tridiag_solve(D.contiguous(), O, g)
        if bool(torch.isfinite(upd).all()):
            return upd
        scale = torch.clamp(torch.amax(torch.abs(D), dim=(-3, -2, -1), keepdim=True),
                            min=1.0)
        Dj = D + self.cfg.fallback_jitter * scale * torch.eye(
            D.shape[-1], dtype=D.dtype, device=D.device)
        return -block_tridiag_solve(Dj.contiguous(), O, g)

    def _line_search(self, xu, update, merit_now, Q, q, x0, lam, rho):
        """n_ls step sizes 2^{0..-(n_ls-1)} in one batched merit call; keep
        the best improving candidate per sample."""
        n_ls = self.cfg.n_ls
        bsz = xu.shape[0]
        steps = 2.0 ** (-torch.arange(n_ls, dtype=xu.dtype, device=xu.device))
        cands = xu[None] + steps[:, None, None, None] * update[None]

        def rep(a):
            return a[None].expand(n_ls, *a.shape).reshape(n_ls * bsz, *a.shape[1:])

        merits = self._merit(cands.reshape(n_ls * bsz, *xu.shape[1:]),
                             rep(Q), rep(q), rep(x0), rep(lam), rep(rho))
        merits = merits.reshape(n_ls, bsz)
        # NaN merits must never win the argmin
        merits = torch.where(torch.isfinite(merits), merits,
                             torch.full_like(merits, float("inf")))
        best = torch.argmin(merits, dim=0)  # (bsz,)
        bidx = torch.arange(bsz, device=xu.device)
        best_merit = merits[best, bidx]
        improved = best_merit < merit_now
        xu_new = torch.where(improved[:, None, None], cands[best, bidx], xu)
        new_merit = torch.where(improved, best_merit, merit_now)
        return xu_new, new_merit, torch.mean(steps[best])

    def __call__(self, xu, x0, lam, rho, Q, q):
        # The caller sets the TF32 flags: off for the reference, on for the
        # benchmark's lower-precision control.
        cfg = self.cfg
        merit = self._merit(xu, Q, q, x0, lam, rho)
        dres_old = self._dyn_res_norm(xu, x0)
        for _ in range(cfg.max_newton_steps):
            g, D, O = self._assemble(xu, Q, q, x0, lam, rho)
            update = self._solve_newton_system(g, D, O)
            xu, merit, stepsz = self._line_search(xu, update, merit, Q, q, x0, lam, rho)
            dres_new = self._dyn_res_norm(xu, x0)
            # global stall / convergence rule (`al_utils.py:558-564`)
            done = ((torch.abs(dres_old - dres_new) / (dres_new + 1e-30) < cfg.dyn_res_tol)
                    | (dres_new < cfg.dyn_res_tol))
            dres_old = dres_new
            if bool(done | ~(stepsz > cfg.min_stepsz)):
                break
        return xu
