"""Batched block-tridiagonal SPD solve, in plain PyTorch.

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
`lax.linalg.cholesky` does: the Newton solver's retry only fires on a
non-finite update.
"""
from __future__ import annotations

import torch


def _cholesky_or_nan(S: torch.Tensor) -> torch.Tensor:
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def _tri_solve(L, B, *, trans=False):
    """Solve L X = B (or L' X = B) for lower-triangular L, batched."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def block_tridiag_solve(D, O, b):
    """Solve H x = b by the block Cholesky factor and two sweeps over T."""
    T = D.shape[1]
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
    Ld, M = torch.stack(Ld, dim=1), torch.stack(M, dim=1)
    ys = []
    # forward: y_t = Ld_t^{-1} (b_t - M_t y_{t-1})
    for t in range(T):
        rhs = b[:, t, :, None]
        if t > 0:
            rhs = rhs - M[:, t] @ ys[t - 1]
        ys.append(_tri_solve(Ld[:, t], rhs))
    # backward: x_t = Ld_t^{-T} (y_t - M_{t+1}' x_{t+1})
    xs = [None] * T
    for t in reversed(range(T)):
        rhs = ys[t]
        if t < T - 1:
            rhs = rhs - M[:, t + 1].mT @ xs[t + 1]
        xs[t] = _tri_solve(Ld[:, t], rhs, trans=True)
    return torch.stack(xs, dim=1)[..., 0]
