"""Interior-point SQP MPC (solver_type "ip").

Port of `IPMPC` (`deqmpc_tpu/solvers/ip_mpc.py:27-292`): linearise the
dynamics at the current iterate, assemble one dense QP over the stacked
trajectory z = [x_0; u_0; ...; x_{T-1}; u_{T-1}] (the diagonal tracking
cost, the banded linearised dynamics and x_0 as equalities, the control
box as inequalities), solve it with the batched PDIPM of `pdipm.py`, and
take a step chosen by a rollout line search. `solve` runs `qp_iter - 1`
such iterations without a gradient, each sample frozen once its control
step is below `eps` and its best iterate kept, then one differentiable
`qp_layer` step from the best iterate, interpolated by the line search's
alpha.

The linearisation (`grad_method`): "analytic", the caller's `dyn_jac`;
"autodiff", `torch.func.jacfwd` of `dyn` per (sample, step); or
"finite_diff", central differences on `dyn`. `elastic` appends l1 slacks
to the equalities (`_sl1qpify`), so an infeasible linearisation stays
solvable. `lindx` rolls out the given time-varying linear model in place
of `dyn`.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from .. import resolve_device
from .pdipm import qp_layer, qp_solve
from .types import LinDx, QuadCost


class IPMPC:
    def __init__(self, nx: int, nu: int, T: int, u_lower=None, u_upper=None,
                 dyn: Callable = None, dyn_jac: Callable = None,
                 qp_iter: int = 1, ipm_iters: int = 18,
                 elastic: bool = False, elastic_mu: float = 10.0,
                 eps: float = 1e-2, grad_method: str = "analytic",
                 fd_eps: float = 1e-4, lindx: Optional[LinDx] = None,
                 dtype=torch.float32, device="cuda"):
        self.nx, self.nu, self.T = nx, nu, T
        self.n = nx + nu
        self.dtype = dtype
        self.device = resolve_device(device)
        self.qp_iter = qp_iter
        self.ipm_iters = ipm_iters
        self.eps = eps
        kw = dict(dtype=dtype, device=self.device)
        self.u_lower = torch.as_tensor(u_lower, **kw)
        self.u_upper = torch.as_tensor(u_upper, **kw)
        self.dyn = dyn
        self.lindx = lindx
        self.fd_eps = fd_eps
        if grad_method == "analytic":
            if dyn_jac is None:
                raise ValueError("grad_method='analytic' needs dyn_jac")
            self.dyn_jac = dyn_jac
        elif grad_method == "autodiff":
            self.dyn_jac = self._jac_autodiff
        elif grad_method == "finite_diff":
            self.dyn_jac = self._jac_finite_diff
        else:
            raise ValueError(f"unknown grad_method {grad_method!r}")
        self.nz = T * self.n
        self.ne = T * nx
        self.ni = 2 * nu * T
        self.elastic = elastic
        self.elastic_mu = elastic_mu
        # the control box, u <= u_hi and -u <= -u_lo at each knot: the same
        # for every sample and every call
        G = torch.zeros((self.ni, self.nz), **kw)
        h = torch.zeros((self.ni,), **kw)
        eye = torch.eye(nu, **kw)
        for t in range(T):
            r, c = 2 * nu * t, t * self.n + nx
            G[r:r + nu, c:c + nu] = eye
            G[r + nu:r + 2 * nu, c:c + nu] = -eye
            h[r:r + nu] = self.u_upper
            h[r + nu:r + 2 * nu] = -self.u_lower
        self._G, self._h = G, h

    # -- linearisations ------------------------------------------------------
    def _jac_autodiff(self, x, u):
        """x_next and [Jx | Ju] by forward mode, per (sample, step)."""
        def step1(xi, ui):
            return self.dyn(xi[None, None], ui[None, None])[0, 0]

        xn = self.dyn(x, u)
        lead = x.shape[:-1]
        xf, uf = x.reshape(-1, self.nx), u.reshape(-1, self.nu)
        with torch.inference_mode(False), torch.no_grad():
            xf, uf = xf.clone(), uf.clone()
            Jx = vmap(jacfwd(step1, argnums=0))(xf, uf)
            Ju = vmap(jacfwd(step1, argnums=1))(xf, uf)
        return xn, torch.cat([Jx, Ju], dim=-1).reshape(*lead, self.nx, self.n)

    def _jac_finite_diff(self, x, u):
        """x_next and the central-difference Jacobian, one column per input."""
        xn = self.dyn(x, u)
        e = self.fd_eps
        cols = []
        for i in range(self.n):
            ex = torch.zeros((self.n,), dtype=x.dtype, device=x.device)
            ex[i] = e
            dx, du = ex[:self.nx], ex[self.nx:]
            cols.append((self.dyn(x + dx, u + du) - self.dyn(x - dx, u - du)) / (2 * e))
        return xn, torch.stack(cols, dim=-1)

    # -- the QP ----------------------------------------------------------------
    def _assemble(self, x, u, x0, cost: QuadCost):
        """Dense (Q, p, G, h, A, b) at the linearisation point (x, u)."""
        bsz = x.shape[0]
        T, nx, n = self.T, self.nx, self.n
        x_next, F = self.dyn_jac(x[:, :-1], u[:, :-1])  # F (bsz, T-1, nx, n)
        c_lin = x_next - torch.einsum("btij,btj->bti", F, torch.cat([x, u], -1)[:, :-1])
        # the block diagonal of diagonal blocks is one diagonal
        Q = torch.diag_embed(cost.Q.reshape(bsz, -1))
        p = cost.q.reshape(bsz, -1)
        # equalities: x_{t+1} - F_t tau_t = c_t (rows t*nx), then x_0 = x0
        eye = torch.eye(nx, dtype=x.dtype, device=x.device)
        A = x.new_zeros((bsz, self.ne, self.nz))
        for t in range(T - 1):
            rows = slice(t * nx, (t + 1) * nx)
            A[:, rows, t * n:(t + 1) * n] = -F[:, t]
            A[:, rows, (t + 1) * n:(t + 1) * n + nx] = eye
        A[:, -nx:, :nx] = eye
        b = torch.cat([c_lin.reshape(bsz, -1), x0], dim=1)
        G = self._G.expand(bsz, self.ni, self.nz)
        h = self._h.expand(bsz, self.ni)
        if self.elastic:
            return self._sl1qpify(Q, p, G, h, A, b)
        return Q, p, G, h, A, b

    def _sl1qpify(self, Q, p, G, h, A, b):
        """Elastic slacks t+, t- on the equalities (`ip_mpc.py:140-163`):
        z_ext = [z; t+; t-], A z + t+ - t- = b, t >= 0 at l1 cost mu, and
        1e-8 on Q's whole diagonal so it stays positive definite."""
        bsz = p.shape[0]
        nz, ne, ni = self.nz, self.ne, self.ni
        nz2 = nz + 2 * ne
        kw = dict(dtype=p.dtype, device=p.device)
        Q2 = torch.zeros((bsz, nz2, nz2), **kw)
        Q2[:, :nz, :nz] = Q
        Q2 = Q2 + 1e-8 * torch.eye(nz2, **kw)
        p2 = torch.cat([p, torch.full((bsz, 2 * ne), self.elastic_mu, **kw)], dim=1)
        eyee = torch.eye(ne, **kw).expand(bsz, ne, ne)
        A2 = torch.cat([A, eyee, -eyee], dim=2)
        Gpad = torch.cat([G, torch.zeros((bsz, ni, 2 * ne), **kw)], dim=2)
        slack_rows = torch.cat([torch.zeros((bsz, 2 * ne, nz), **kw),
                                -torch.eye(2 * ne, **kw).expand(bsz, 2 * ne, 2 * ne)], dim=2)
        G2 = torch.cat([Gpad, slack_rows], dim=1)
        h2 = torch.cat([h, torch.zeros((bsz, 2 * ne), **kw)], dim=1)
        return Q2, p2, G2, h2, A2, b

    # -- rollout, cost and line search ------------------------------------------
    def _rollout(self, x0, u):
        """States under the controls u (..., T, nu) from x0 (..., nx), by
        the true dynamics or by `lindx`; leading dims may be (candidates,
        batch)."""
        xs = [x0]
        for t in range(self.T - 1):
            if self.lindx is not None:
                xu = torch.cat([xs[-1], u[..., t, :]], dim=-1)
                xs.append(torch.einsum("...ij,...j->...i", self.lindx.F[:, t], xu)
                          + self.lindx.f[:, t])
            else:
                xs.append(self.dyn(xs[-1], u[..., t, :]))
        return torch.stack(xs, dim=-2)

    @staticmethod
    def _cost_of(x, u, cost: QuadCost):
        """sum over the horizon of 0.5 tau'diag(Q)tau + q'tau."""
        tau = torch.cat([x, u], dim=-1)
        return torch.sum(0.5 * cost.Q * tau * tau + cost.q * tau, dim=(-2, -1))

    def _line_search(self, xc, uc, x_new, u_new, x0, cost):
        """Ten step sizes 0.2^k rolled out at once; each sample takes the
        largest that lowers its cost, else the smallest (`ip_mpc.py:227-254`).
        Returns (x, u, alpha (bsz, 1, 1), cost)."""
        K = 10
        alphas = 0.2 ** torch.arange(K, dtype=self.dtype, device=xc.device)
        cost0 = self._cost_of(xc, uc, cost)
        cands_u = uc[None] + alphas[:, None, None, None] * (u_new - uc)[None]
        cands_x = self._rollout(x0.expand(K, *x0.shape), cands_u)
        costs = self._cost_of(cands_x, cands_u, cost)  # (K, bsz)
        improves = costs < cost0[None]
        first = torch.argmax(improves.to(torch.int8), dim=0)
        kidx = torch.where(improves.any(dim=0), first, torch.full_like(first, K - 1))
        ar = torch.arange(xc.shape[0], device=xc.device)
        return (cands_x[kidx, ar], cands_u[kidx, ar], alphas[kidx][:, None, None],
                costs[kidx, ar])

    def solve(self, x0, cost: QuadCost, x_init=None, u_init=None) -> Tuple[torch.Tensor,
                                                                           torch.Tensor]:
        """The SQP loop (`ip_mpc.py:256-292`); returns (x, u), differentiable
        through the final QP into the cost (and anything the QP's inputs
        depend on)."""
        bsz = x0.shape[0]
        T, nx, n = self.T, self.nx, self.n
        dt = self.dtype
        x0 = x0.to(dt)
        u = u_init.to(dt) if u_init is not None else x0.new_zeros((bsz, T, self.nu))
        x = x_init.to(dt) if x_init is not None else self._rollout(x0, u)
        frozen = torch.zeros((bsz,), dtype=torch.bool, device=x0.device)
        best_x, best_u = x, u
        with torch.no_grad():
            best_cost = self._cost_of(x, u, cost)

        def split(z):
            tau = z[:, :self.nz].reshape(bsz, T, n)
            return tau[..., :nx], tau[..., nx:]

        for _ in range(self.qp_iter - 1):
            with torch.no_grad():
                xc, uc = x.detach(), u.detach()
                z = qp_solve(*self._assemble(xc, uc, x0, cost), self.ipm_iters).z
                x_ls, u_ls, _, cost_ls = self._line_search(xc, uc, *split(z), x0, cost)
                keep = frozen[:, None, None]
                x = torch.where(keep, xc, x_ls)
                u = torch.where(keep, uc, u_ls)
                take = (cost_ls <= best_cost + 1e-4) & ~frozen
                best_x = torch.where(take[:, None, None], x_ls, best_x)
                best_u = torch.where(take[:, None, None], u_ls, best_u)
                best_cost = torch.where(take, cost_ls, best_cost)
                du = torch.linalg.vector_norm((u_ls - uc).reshape(bsz, -1), dim=-1)
                frozen = frozen | (du < self.eps)
        xc, uc = best_x.detach(), best_u.detach()
        z = qp_layer(*self._assemble(xc, uc, x0, cost), self.ipm_iters)
        x_new, u_new = split(z)
        with torch.no_grad():
            _, _, alpha, _ = self._line_search(xc, uc, x_new.detach(), u_new.detach(), x0, cost)
        return xc + alpha * (x_new - xc), uc + alpha * (u_new - uc)
