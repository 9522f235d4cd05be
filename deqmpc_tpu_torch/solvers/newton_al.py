"""NewtonAL: the inner Newton solver on the AL merit, with its implicit
backward.

Port of `deqmpc_tpu/solvers/newton_al.py:58-233`. The forward:

  * at most `max_newton_steps` Newton steps with the same global exits
    as the JAX `lax.while_loop` (dyn-res stall or convergence, small
    step). Here the loop is a Python loop that reads its exit on the
    host once per Newton step: the same information the while loop's
    condition needs;
  * the Newton system is solved with `ops.block_tridiag_solve`: the CUDA
    kernel on the card, the plain version on the CPU;
  * a non-finite update anywhere in the batch retries the solve once
    with a strongly jittered diagonal (`newton_al.py:110-126`);
  * the 20 step sizes 2^{0..-19} of the line search are evaluated in one
    batched merit call; NaN merits never win, and only improvements are
    accepted (`newton_al.py:130-147`);
  * with `cfg.state_estimator` (the MHE flavour, `newton_al.py:70-96`)
    there is no initial-state row (a zero row keeps the shapes) and no
    S'S on block 0, in the merit, the residual norm, the assembly and the
    implicit backward's (D, O); the caller passes u_lower None (no box);
  * the selected obstacles, an `ObstacleSet` or None, come with each call
    (`obs=`) and reach the merit, the residual norm, the assembly and the
    implicit backward's (D, O). JAX reads them through a closure over the
    solver's state (`newton_al.py:59-65,159`); here nothing is stored;
  * the phases are spans of `utils.profiling`: `newton.start`, then per
    Newton step `newton.step` holding `newton.linearize`,
    `newton.assemble`, `newton.b1`, `newton.retry`, `newton.line_search`
    and `newton.residual`; each of the two host reads a step sits in a
    `sync.*` span and adds one to the `host_reads` counter.

The backward is the JAX package's `custom_vjp` (`newton_al.py:203-232`)
as a `torch.autograd.Function`: the forward loop runs on detached inputs,
then the Hessian blocks (D, O) are assembled once more at the final
iterate and saved. The backward solves dx = -H^{-1} g_out with the same
`block_tridiag_solve` (the CUDA kernel on the card; no jittered retry),
sets non-finite entries to 0, and returns dQ = dx * xu_out, dq = dx;
xu, x0, lam and rho get zero cotangents. Under `torch.inference_mode()`,
or whenever neither Q nor q needs a gradient, the loop runs alone, with
no extra assembly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from ..ops.block_tridiag import block_tridiag_solve
from ..parallel import collectives
from ..utils import profiling
from .al_core import ObstacleSet, full_residuals, merit_function, merit_grad_blocks
from .types import NewtonALConfig


@dataclasses.dataclass
class NewtonCounts:
    """What a NewtonAL has done: `steps` Newton steps taken, so a run can
    check that each one went through the solve kernel; `retries` jittered
    re-solves; `backward_solves` implicit-backward solves, over
    `backward_samples` samples, of which `backward_zeroed` (a device
    tensor once a backward ran, read without a sync per solve) had their
    gradient set to 0."""

    steps: int = 0
    retries: int = 0
    backward_solves: int = 0
    backward_samples: int = 0
    backward_zeroed: Union[int, torch.Tensor] = 0


def _count(name: str) -> property:
    return property(lambda self: getattr(self.counts, name),
                    lambda self, v: setattr(self.counts, name, v))


class NewtonAL:
    """newton_al(xu, x0, lam, rho, Q, q, obs=None) -> (xu_out, status).

    dyn(x, u): batched discrete dynamics over leading dims.
    dyn_jac(x, u): -> (x_next, F) with F = [A B]: (..., nx, nx+nu).
    The counters of `NewtonCounts` read as attributes (`steps`, ...);
    `with_dynamics` gives the same solver on other dynamics, counting into
    the same counters."""

    steps = _count("steps")
    retries = _count("retries")
    backward_solves = _count("backward_solves")
    backward_samples = _count("backward_samples")
    backward_zeroed = _count("backward_zeroed")

    def __init__(self, cfg: NewtonALConfig, dyn: Callable, dyn_jac: Callable,
                 u_lower, u_upper, counts: Optional[NewtonCounts] = None):
        self.cfg = cfg
        self.dyn = dyn
        self.dyn_jac = dyn_jac
        self.u_lower = u_lower
        self.u_upper = u_upper
        self.counts = NewtonCounts() if counts is None else counts

    def with_dynamics(self, dyn: Callable, dyn_jac: Callable) -> "NewtonAL":
        """This solver on the dynamics (dyn, dyn_jac), e.g. a model
        linearised for one call; its steps and solves count here too."""
        return NewtonAL(self.cfg, dyn, dyn_jac, self.u_lower, self.u_upper, self.counts)

    # -- pieces -----------------------------------------------------------------
    def _merit(self, xu, Q, q, x0, lam, rho, obs):
        return merit_function(self.dyn, xu, Q, q, x0, lam, rho,
                              self.u_lower, self.u_upper, obs, self.cfg.state_estimator)

    def _dyn_res_norm(self, xu, x0, obs):
        """Norm of the clamped residuals over the whole batch (every
        process's shard): the exit rule is global, as in the JAX package."""
        nx = self.cfg.nx
        _, res_c = full_residuals(self.dyn, xu[..., :nx], xu[..., nx:], x0,
                                  self.u_lower, self.u_upper, obs, self.cfg.state_estimator)
        return collectives.global_norm(res_c)

    def _assemble(self, xu, Q, q, x0, lam, rho, obs):
        nx = self.cfg.nx
        x, u = xu[..., :nx], xu[..., nx:]
        with profiling.span("newton.linearize"):
            x_next, F = self.dyn_jac(x[:, :-1], u[:, :-1])
        with profiling.span("newton.assemble"):
            defects = x[:, 1:] - x_next
            last = (torch.zeros_like(defects[:, :1]) if self.cfg.state_estimator
                    else (x[:, 0] - x0)[:, None])
            return merit_grad_blocks(xu, Q, q, x0, lam, rho, F, self.u_lower,
                                     self.u_upper, dyn_eq_res=torch.cat([defects, last], dim=1),
                                     obs=obs, state_estimator=self.cfg.state_estimator)

    @staticmethod
    def _all_finite(upd) -> bool:
        """Whether the update is finite on every sample of the whole batch
        (every process's shard): one host read."""
        with profiling.span("sync.finite"):
            profiling.count("host_reads")
            return collectives.all_true(torch.isfinite(upd).all())

    def _solve_newton_system(self, g, D, O):
        """Solve H x = -g; retry once with a jittered diagonal when the
        result has a non-finite entry anywhere in the batch."""
        with profiling.span("newton.b1"):
            O, g = O.contiguous(), g.contiguous()
            upd = -block_tridiag_solve(D.contiguous(), O, g)
        if self._all_finite(upd):
            return upd
        self.retries += 1
        with profiling.span("newton.retry"):
            scale = torch.clamp(torch.amax(torch.abs(D), dim=(-3, -2, -1), keepdim=True),
                                min=1.0)
            Dj = D + self.cfg.fallback_jitter * scale * torch.eye(
                D.shape[-1], dtype=D.dtype, device=D.device)
            return -block_tridiag_solve(Dj.contiguous(), O, g)

    def _line_search(self, xu, update, merit_now, Q, q, x0, lam, rho, obs):
        """n_ls step sizes 2^{0..-(n_ls-1)} in one batched merit call; keep
        the best improving candidate per sample."""
        n_ls = self.cfg.n_ls
        bsz = xu.shape[0]
        steps = 2.0 ** (-torch.arange(n_ls, dtype=xu.dtype, device=xu.device))
        cands = xu[None] + steps[:, None, None, None] * update[None]

        def rep(a):
            return a[None].expand(n_ls, *a.shape).reshape(n_ls * bsz, *a.shape[1:])

        obs_rep = None if obs is None else ObstacleSet(rep(obs.centers), obs.radius)
        merits = self._merit(cands.reshape(n_ls * bsz, *xu.shape[1:]),
                             rep(Q), rep(q), rep(x0), rep(lam), rep(rho), obs_rep)
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
        return xu_new, new_merit, collectives.batch_mean(steps[best])

    # -- forward ----------------------------------------------------------------
    def __call__(self, xu, x0, lam, rho, Q, q, obs: Optional[ObstacleSet] = None):
        """(xu_out, status). Differentiable in Q and q when grad mode is on.
        `obs`: the obstacles selected for this call, or None."""
        if torch.is_grad_enabled() and (Q.requires_grad or q.requires_grad):
            return _NewtonALFunction.apply(self, xu, x0, lam, rho, Q, q, obs)
        return self._forward(xu, x0, lam, rho, Q, q, obs)

    def _forward(self, xu, x0, lam, rho, Q, q, obs=None):
        # The solver runs in full f32 on the card: the counterpart of the
        # JAX package's default_matmul_precision("highest") scope
        # (`newton_al.py:149-156`). The flags are process-wide in PyTorch,
        # so the DEQ network's matmuls, and in training its backward, run
        # in full f32 too: PyTorch's default for matmuls, so no number moves.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cfg
        bsz = xu.shape[0]
        with profiling.span("newton.start"):
            merit = self._merit(xu, Q, q, x0, lam, rho, obs)
            dres_old = self._dyn_res_norm(xu, x0, obs)
        status = torch.ones((bsz,), dtype=torch.bool, device=xu.device)
        for _ in range(cfg.max_newton_steps):
            with profiling.span("newton.step"):
                g, D, O, _, _ = self._assemble(xu, Q, q, x0, lam, rho, obs)
                update = self._solve_newton_system(g, D, O)
                self.steps += 1
                with profiling.span("newton.line_search"):
                    xu, merit, stepsz = self._line_search(xu, update, merit, Q, q, x0, lam,
                                                          rho, obs)
                status = status & torch.isfinite(xu.reshape(bsz, -1)).all(dim=-1)
                with profiling.span("newton.residual"):
                    dres_new = self._dyn_res_norm(xu, x0, obs)
                # global stall / convergence rule (`al_utils.py:558-564`)
                done = ((torch.abs(dres_old - dres_new) / (dres_new + 1e-30) < cfg.dyn_res_tol)
                        | (dres_new < cfg.dyn_res_tol))
                dres_old = dres_new
                # one host read per Newton step: the while loop's condition
                stop = done | ~(stepsz > cfg.min_stepsz)
                with profiling.span("sync.stop"):
                    profiling.count("host_reads")
                    stop = bool(stop)
            if stop:
                break
        return xu, status


def implicit_grads(D, O, xu_out, g_out):
    """The implicit backward at the solution (`newton_al.py:211-222`):
    dx = -H^{-1} g_out, non-finite entries set to 0 (a sample whose
    Hessian is not positive definite gets no gradient instead of
    poisoning the batch). Returns (dQ, dq) = (dx * xu_out, dx) and the
    number of samples with a non-finite entry, as a device tensor."""
    dx = -block_tridiag_solve(D.contiguous(), O.contiguous(), g_out.contiguous())
    finite = torch.isfinite(dx)
    zeroed = (~finite).flatten(1).any(dim=1).sum()
    dx = torch.where(finite, dx, torch.zeros_like(dx))
    return dx * xu_out, dx, zeroed


class _NewtonALFunction(torch.autograd.Function):
    """NewtonAL with the JAX package's implicit VJP: only Q and q get
    gradients. The backward's (D, O) hold the same obstacle rows as the
    forward's."""

    @staticmethod
    def forward(ctx, newton, xu, x0, lam, rho, Q, q, obs):
        xu_out, status = newton._forward(xu, x0, lam, rho, Q, q, obs)
        # Hessian blocks at the solution, for the backward
        _, D, O, _, _ = newton._assemble(xu_out, Q, q, x0, lam, rho, obs)
        ctx.newton = newton
        ctx.zero_cots = [(t.shape, t.dtype, t.device) for t in (xu, x0, lam, rho)]
        ctx.save_for_backward(D, O, xu_out)
        ctx.mark_non_differentiable(status)
        return xu_out, status

    @staticmethod
    def backward(ctx, g_out, _status_cot):
        D, O, xu_out = ctx.saved_tensors
        dQ, dq, zeroed = implicit_grads(D, O, xu_out, g_out)
        newton = ctx.newton
        newton.backward_solves += 1
        newton.backward_samples += xu_out.shape[0]
        newton.backward_zeroed = newton.backward_zeroed + zeroed
        # xu, x0, lam and rho get zero cotangents, as in the JAX package
        zeros = [torch.zeros(shape, dtype=dtype, device=device) if need else None
                 for (shape, dtype, device), need in zip(ctx.zero_cots,
                                                         ctx.needs_input_grad[1:5])]
        return (None, *zeros, dQ if ctx.needs_input_grad[5] else None,
                dq if ctx.needs_input_grad[6] else None, None)
