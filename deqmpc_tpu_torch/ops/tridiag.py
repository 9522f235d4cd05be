"""Batched block-tridiagonal SPD factor / solve: the plain PyTorch version.

Port of `deqmpc_tpu/ops/tridiag.py:37-129`. It is the CPU path of
`ops.block_tridiag.block_tridiag_solve` and the oracle the CUDA kernel
is held against on the card; it is never a fallback for CUDA tensors.

Layout:
  D: (bsz, T, n, n)   diagonal blocks (symmetric)
  O: (bsz, T-1, n, n) super-diagonal blocks, H[t, t+1] = O[t]
  b: (bsz, T, n)      right-hand side

Factorization (lower block bidiagonal L with diagonal Cholesky blocks
Ld[t] and sub-diagonal blocks M[t] = O[t-1]' Ld[t-1]^{-T}):
  Ld[0] Ld[0]' = D[0]
  M[t]         = O[t-1]' Ld[t-1]^{-T}
  Ld[t] Ld[t]' = D[t] - M[t] M[t]'

A block that is not positive definite factors to NaN, as
`lax.linalg.cholesky` does: the NewtonAL retry only fires on a
non-finite update (`deqmpc_tpu/solvers/newton_al.py:110-126`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BTFactor(NamedTuple):
    Ld: torch.Tensor  # (bsz, T, n, n) lower-triangular Cholesky blocks
    M: torch.Tensor   # (bsz, T, n, n); M[:, 0] unused (zeros)


def _cholesky_or_nan(S: torch.Tensor) -> torch.Tensor:
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def _tri_solve(L, B, *, trans=False):
    """Solve L X = B (or L' X = B) for lower-triangular L, batched."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def block_tridiag_factor(D, O, jitter: float = 0.0) -> BTFactor:
    """Block Cholesky of an SPD block-tridiagonal matrix, a loop over T."""
    T, n = D.shape[1], D.shape[-1]
    if jitter:
        D = D + jitter * torch.eye(n, dtype=D.dtype, device=D.device)
    Ld, M = [], []
    for t in range(T):
        S = D[:, t]
        if t == 0:
            M_t = torch.zeros_like(S)
        else:
            # M_t = O_{t-1}' Ld_{t-1}^{-T}: solve Ld_{t-1} X = O_{t-1}, M = X'
            M_t = _tri_solve(Ld[t - 1], O[:, t - 1]).mT
            S = S - M_t @ M_t.mT
        Ld.append(_cholesky_or_nan(S))
        M.append(M_t)
    return BTFactor(Ld=torch.stack(Ld, dim=1), M=torch.stack(M, dim=1))


def block_tridiag_solve_factored(fac: BTFactor, b):
    """Solve H x = b given the factorization. b: (bsz, T, n)."""
    T = b.shape[1]
    ys = []
    # forward: y_t = Ld_t^{-1} (b_t - M_t y_{t-1})
    for t in range(T):
        rhs = b[:, t, :, None]
        if t > 0:
            rhs = rhs - fac.M[:, t] @ ys[t - 1]
        ys.append(_tri_solve(fac.Ld[:, t], rhs))
    # backward: x_t = Ld_t^{-T} (y_t - M_{t+1}' x_{t+1})
    xs = [None] * T
    for t in reversed(range(T)):
        rhs = ys[t]
        if t < T - 1:
            rhs = rhs - fac.M[:, t + 1].mT @ xs[t + 1]
        xs[t] = _tri_solve(fac.Ld[:, t], rhs, trans=True)
    return torch.stack(xs, dim=1)[..., 0]


def block_tridiag_solve(D, O, b, jitter: float = 0.0):
    return block_tridiag_solve_factored(block_tridiag_factor(D, O, jitter), b)


def block_tridiag_matvec(D, O, v):
    """H v (tests): v (bsz, T, n)."""
    out = torch.einsum("btij,btj->bti", D, v)
    upper = torch.einsum("btij,btj->bti", O, v[:, 1:])
    lower = torch.einsum("btji,btj->bti", O, v[:, :-1])
    out = out.clone()
    out[:, :-1] += upper
    out[:, 1:] += lower
    return out


def block_tridiag_dense(D, O):
    """Materialize the dense H (tests, and the library yardstick on the
    card). (bsz, T*n, T*n)."""
    bsz, T, n, _ = D.shape
    H = torch.zeros((bsz, T * n, T * n), dtype=D.dtype, device=D.device)
    for t in range(T):
        H[:, t * n:(t + 1) * n, t * n:(t + 1) * n] = D[:, t]
        if t < T - 1:
            H[:, t * n:(t + 1) * n, (t + 1) * n:(t + 2) * n] = O[:, t]
            H[:, (t + 1) * n:(t + 2) * n, t * n:(t + 1) * n] = O[:, t].mT
    return H
