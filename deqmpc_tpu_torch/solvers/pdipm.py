"""Batched primal-dual interior-point QP solver and its differentiable layer.

Port of `QPSolution`, `_kkt_residuals`, `_solve_kkt`, `_chol_solve`,
`KKTFactors`, `pre_factor_kkt`, `_solve_kkt_prefactored`, `qp_solve`,
`qp_layer` and `qp_solve_single` (`deqmpc_tpu/solvers/pdipm.py:32-340`).
Solves, batched over samples,

    min_z 0.5 z'Qz + p'z   s.t.  Gz <= h,  Az = b

with Mehrotra's predictor-corrector for a fixed number of iterations,
keeping each sample's best iterate (least KKT residual). The Newton-KKT
systems are dense and small; they are solved with `torch.linalg` as the
JAX package solves them with `jnp.linalg`, outside any kernel. The `_ex`
variants are used so that no call waits on the device to check for a
failure: a factorization that fails gives NaN in its sample, as
`jnp.linalg.cholesky` does.

`qp_layer` is an autograd Function whose backward is implicit
differentiation through the KKT residual map F(z, s, lam, nu; Q, p, G, h,
A, b) at mu = 0 (`pdipm.py:277-326`): solve (dF/dsol)' w = [dL/dz; 0]
with the same 1e-10 shift, then pull -w back to the six inputs. dF/dsol
and the pull-back are written out (F is bilinear, so both are exact),
where JAX takes them from `jax.jacfwd` and `jax.vjp`.

`counts` records the dense KKT solves (`kkt`: one per factorization of a
forward Newton step; `backward`: one per backward call), so a run can
report how many the interior-point path makes.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch

counts = collections.Counter()


class QPSolution(NamedTuple):
    z: torch.Tensor     # (bsz, nz)
    s: torch.Tensor     # (bsz, ni) slacks
    lam: torch.Tensor   # (bsz, ni) inequality duals
    nu: torch.Tensor    # (bsz, ne) equality duals
    res: torch.Tensor   # (bsz,) KKT residual norm of the kept iterate


def _mv(M, v):
    return torch.einsum("bij,bj->bi", M, v)


def _mtv(M, v):
    return torch.einsum("bij,bi->bj", M, v)


def _kkt_residuals(z, s, lam, nu, Q, p, G, h, A, b, mu=0.0):
    rz = _mv(Q, z) + p + _mtv(G, lam)
    if A.shape[1] > 0:
        rz = rz + _mtv(A, nu)
    rs = lam * s - mu
    ri = _mv(G, z) + s - h
    re = _mv(A, z) - b if A.shape[1] > 0 else torch.zeros_like(b)
    return rz, rs, ri, re


def _solve_kkt(Q, G, A, s, lam, rz, rs, ri, re, eps=1e-9):
    """The symmetrized Newton-KKT system
    K = [[Q, G', A'], [G, -diag(s/lam + eps), 0], [A, 0, 0]], solved dense
    for (dz, dlam, dnu); ds from the slack row."""
    bsz, ni, nz = G.shape
    ne = A.shape[1]
    N = nz + ni + ne
    K = Q.new_zeros((bsz, N, N))
    K[:, :nz, :nz] = Q
    K[:, :nz, nz:nz + ni] = G.mT
    K[:, nz:nz + ni, :nz] = G
    K[:, nz:nz + ni, nz:nz + ni] = -torch.diag_embed(s / lam + eps)
    if ne > 0:
        K[:, :nz, nz + ni:] = A.mT
        K[:, nz + ni:, :nz] = A
    rhs = torch.cat([-rz, -ri + rs / lam, -re], dim=1)[..., None]
    counts["kkt"] += 1
    sol = torch.linalg.solve_ex(K, rhs)[0][..., 0]
    dz, dlam, dnu = sol[:, :nz], sol[:, nz:nz + ni], sol[:, nz + ni:]
    ds = -(rs + s * dlam) / lam
    return dz, ds, dlam, dnu


def _cholesky(M):
    """Lower Cholesky factor; NaN in every sample whose matrix is not
    positive definite (as `jnp.linalg.cholesky`)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))


def _chol_solve(L, B):
    """Batched solve of (L L') X = B given lower-triangular L."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


class KKTFactors(NamedTuple):
    """The factorizations of the Schur-complement KKT solve that do not
    change between interior-point iterations (`pdipm.py:99-117`):
    Lq = chol(Q), La = chol(A Q^-1 A') and R = G Q^-1 G' - (G Q^-1 A')
    (A Q^-1 A')^-1 (A Q^-1 G'); each iteration factors only
    T = R + diag(s/lam)."""

    Lq: torch.Tensor          # (bsz, nz, nz)
    invQ_GT: torch.Tensor     # (bsz, nz, ni)
    G_invQ_GT: torch.Tensor   # (bsz, ni, ni)
    La: torch.Tensor          # (bsz, ne, ne), (bsz, 0, 0) when ne = 0
    invQ_AT: torch.Tensor     # (bsz, nz, ne)
    G_invQ_AT: torch.Tensor   # (bsz, ni, ne)
    R: torch.Tensor           # (bsz, ni, ni)


def pre_factor_kkt(Q, G, A) -> KKTFactors:
    bsz, ni, nz = G.shape
    ne = A.shape[1]
    Lq = _cholesky(Q)
    invQ_GT = _chol_solve(Lq, G.mT)
    G_invQ_GT = G @ invQ_GT
    if ne > 0:
        invQ_AT = _chol_solve(Lq, A.mT)
        G_invQ_AT = G @ invQ_AT
        La = _cholesky(A @ invQ_AT)
        R = G_invQ_GT - G_invQ_AT @ _chol_solve(La, G_invQ_AT.mT)
    else:
        invQ_AT = Q.new_zeros((bsz, nz, 0))
        G_invQ_AT = Q.new_zeros((bsz, ni, 0))
        La = Q.new_zeros((bsz, 0, 0))
        R = G_invQ_GT
    return KKTFactors(Lq, invQ_GT, G_invQ_GT, La, invQ_AT, G_invQ_AT, R)


def _solve_kkt_prefactored(fac: KKTFactors, G, A, s, lam, rz, rs, ri, re, eps=1e-9):
    """The Newton step of `_solve_kkt` by block elimination through the
    pre-factored Schur blocks (`pdipm.py:141-183`)."""
    ne = A.shape[1]
    col = lambda v: v[..., None]  # noqa: E731
    Lt = _cholesky(fac.R + torch.diag_embed(s / lam + eps))
    counts["kkt"] += 1
    invQ_rz = _chol_solve(fac.Lq, col(rz))[..., 0]
    b2 = ri - rs / lam - _mv(G, invQ_rz)
    if ne > 0:
        b1 = re - _mv(A, invQ_rz)
        y1 = _chol_solve(fac.La, col(b1))[..., 0]
        dlam = _chol_solve(Lt, col(b2 - _mv(fac.G_invQ_AT, y1)))[..., 0]
        dnu = _chol_solve(fac.La, col(b1 - _mtv(fac.G_invQ_AT, dlam)))[..., 0]
        dz = -_chol_solve(fac.Lq, col(rz + _mtv(G, dlam) + _mtv(A, dnu)))[..., 0]
    else:
        dlam = _chol_solve(Lt, col(b2))[..., 0]
        dnu = s.new_zeros((s.shape[0], 0))
        dz = -_chol_solve(fac.Lq, col(rz + _mtv(G, dlam)))[..., 0]
    ds = -(rs + s * dlam) / lam
    return dz, ds, dlam, dnu


def _max_step(v, dv):
    """The largest alpha in (0, 1] keeping v + alpha dv >= 0, per sample."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return torch.clamp(torch.amin(ratio, dim=1), max=1.0)


def qp_solve(Q, p, G, h, A, b, iters: int = 18, prefactor: bool = False) -> QPSolution:
    """Mehrotra predictor-corrector, `iters` iterations, batched
    (`pdipm.py:186-274`). prefactor=True solves each Newton step through
    `pre_factor_kkt`; the default factors the dense KKT matrix each time.
    Both give the same steps. Runs without a gradient: `qp_layer` is the
    differentiable entry."""
    with torch.no_grad():
        return _qp_solve_body(Q, p, G, h, A, b, iters, prefactor)


def _qp_solve_body(Q, p, G, h, A, b, iters, prefactor):
    bsz, nz = p.shape
    ni, ne = G.shape[1], A.shape[1]
    if prefactor:
        fac = pre_factor_kkt(Q, G, A)

        def kkt(s, lam, rz, rs, ri, re):
            return _solve_kkt_prefactored(fac, G, A, s, lam, rz, rs, ri, re)
    else:
        def kkt(s, lam, rz, rs, ri, re):
            return _solve_kkt(Q, G, A, s, lam, rz, rs, ri, re)

    # the start: one KKT solve at s = lam = 1, then shifted into the
    # positive orthant
    s0, l0 = p.new_ones((bsz, ni)), p.new_ones((bsz, ni))
    nu0, z0 = p.new_zeros((bsz, ne)), p.new_zeros((bsz, nz))
    dz, ds, dlam, dnu = kkt(s0, l0, *_kkt_residuals(z0, s0, l0, nu0, Q, p, G, h, A, b))
    z, nu = z0 + dz, nu0 + dnu
    s_cand, l_cand = s0 + ds, l0 + dlam
    s = s_cand + torch.clamp(-torch.amin(s_cand, dim=1, keepdim=True), min=0.0) + 1.0
    lam = l_cand + torch.clamp(-torch.amin(l_cand, dim=1, keepdim=True), min=0.0) + 1.0

    def res_norm(z, s, lam, nu):
        rz, _, ri, re = _kkt_residuals(z, s, lam, nu, Q, p, G, h, A, b)
        gap = torch.abs(torch.sum(s * lam, dim=1)) / ni
        return (torch.linalg.vector_norm(rz, dim=1) + torch.linalg.vector_norm(ri, dim=1)
                + torch.linalg.vector_norm(re, dim=1) + gap)

    best = [z, s, lam, nu, res_norm(z, s, lam, nu)]
    for _ in range(iters):
        rz, rs, ri, re = _kkt_residuals(z, s, lam, nu, Q, p, G, h, A, b)
        # affine (predictor) step
        dz_a, ds_a, dl_a, _ = kkt(s, lam, rz, rs, ri, re)
        alpha_a = torch.minimum(_max_step(s, ds_a), _max_step(lam, dl_a))[:, None]
        mu = torch.sum(s * lam, dim=1) / ni
        mu_aff = torch.sum((s + alpha_a * ds_a) * (lam + alpha_a * dl_a), dim=1) / ni
        sigma = (mu_aff / (mu + 1e-30)) ** 3
        # corrector and centering
        rs_c = rs + ds_a * dl_a - (sigma * mu)[:, None]
        dz, ds, dlam, dnu = kkt(s, lam, rz, rs_c, ri, re)
        alpha = 0.99 * torch.minimum(_max_step(s, ds), _max_step(lam, dlam))[:, None]
        z, s, lam, nu = z + alpha * dz, s + alpha * ds, lam + alpha * dlam, nu + alpha * dnu
        r = res_norm(z, s, lam, nu)
        better = r < best[4]
        best = [torch.where(better[:, None], new, old)
                for new, old in zip((z, s, lam, nu), best[:4])] + [torch.where(better, r, best[4])]
    return QPSolution(*best)


def _kkt_jacobian(s, lam, Q, G, A):
    """dF/d(z, s, lam, nu) of the flat residual map
    F = [Qz + p + G'lam + A'nu; lam*s; Gz + s - h; Az - b]."""
    bsz, ni, nz = G.shape
    ne = A.shape[1]
    N = nz + 2 * ni + ne
    J = Q.new_zeros((bsz, N, N))
    # the blocks of z, s, lam and nu; F's rows come in the same blocks
    zs, ss, ls, ns = (slice(0, nz), slice(nz, nz + ni), slice(nz + ni, nz + 2 * ni),
                      slice(nz + 2 * ni, N))
    J[:, zs, zs] = Q
    J[:, zs, ls] = G.mT
    J[:, zs, ns] = A.mT
    J[:, ss, ss] = torch.diag_embed(lam)
    J[:, ss, ls] = torch.diag_embed(s)
    J[:, ls, zs] = G
    J[:, ls, ss] = torch.eye(ni, dtype=Q.dtype, device=Q.device)
    J[:, ns, zs] = A
    return J


def qp_layer_backward(sol: QPSolution, Q, G, A, gz):
    """The six gradients of the implicit backward, (dQ, dp, dG, dh, dA,
    db), for the cotangent gz of z*."""
    ni, ne = G.shape[1], A.shape[1]
    J = _kkt_jacobian(sol.s, sol.lam, Q, G, A)
    rhs = torch.cat([gz, gz.new_zeros((gz.shape[0], 2 * ni + ne))], dim=1)[..., None]
    shift = 1e-10 * torch.eye(J.shape[-1], dtype=J.dtype, device=J.device)
    counts["backward"] += 1
    w = torch.linalg.solve_ex(J.mT + shift, rhs)[0][..., 0]
    return _pull_back(-w, sol)


def _pull_back(v, sol: QPSolution):
    """v' dF/d(Q, p, G, h, A, b) at the solution, for v (bsz, N)."""
    z, lam, nu = sol.z, sol.lam, sol.nu
    nz, ni = z.shape[1], lam.shape[1]
    vz, vi, ve = v[:, :nz], v[:, nz + ni:nz + 2 * ni], v[:, nz + 2 * ni:]
    outer = lambda a, c: a[:, :, None] * c[:, None, :]  # noqa: E731
    dQ = outer(vz, z)
    dG = outer(lam, vz) + outer(vi, z)
    dA = outer(nu, vz) + outer(ve, z)
    return dQ, vz, dG, -vi, dA, -ve


class _QPLayerFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Q, p, G, h, A, b, iters):
        sol = qp_solve(Q, p, G, h, A, b, iters)
        ctx.save_for_backward(sol.z, sol.s, sol.lam, sol.nu, Q, G, A)
        return sol.z

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gz):
        z, s, lam, nu, Q, G, A = ctx.saved_tensors
        sol = QPSolution(z, s, lam, nu, None)
        return (*qp_layer_backward(sol, Q, G, A, gz.contiguous()), None)


def qp_layer(Q, p, G, h, A, b, iters: int = 18):
    """Differentiable QP: the primal solution z* (bsz, nz), with the
    implicit backward into all six inputs."""
    return _QPLayerFunction.apply(Q, p, G, h, A, b, iters)


def qp_solve_single(Q, p, G, h, A=None, b=None, iters: int = 18,
                    prefactor: bool = False) -> QPSolution:
    """One unbatched QP (`pdipm.py:329-340`): a batch of one."""
    nz = p.shape[0]
    if A is None:
        A, b = p.new_zeros((0, nz)), p.new_zeros((0,))
    sol = qp_solve(Q[None], p[None], G[None], h[None], A[None], b[None], iters=iters,
                   prefactor=prefactor)
    return QPSolution(*(x[0] for x in sol))
