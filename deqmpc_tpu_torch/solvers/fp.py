"""Anderson acceleration for the DEQ layer.

Port of `anderson` (`deqmpc_tpu/solvers/fp.py:30-163`) with the JAX
semantics: it runs exactly `max_steps` iterations and ignores `tol`
(`fp.py:79-86`), tracks each sample's best iterate with masks, and
solves the (m+1)x(m+1) bordered mixing system with the unrolled
modified-Gram-Schmidt QR of `fp.py:36-68`, with unfilled slots pinned
to identity rows so their weights are exactly zero. The history
buffers are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class FPInfo(NamedTuple):
    best_err: torch.Tensor    # (bsz,) best relative residual
    best_step: torch.Tensor   # (bsz,) iteration index of the best iterate
    final_err: torch.Tensor   # (bsz,) last-iterate residual


def _solve_small_qr(H, y):
    """Batched tiny general solve H x = y by unrolled MGS-QR and
    back-substitution. H: (bsz, n, n), y: (bsz, n) -> (bsz, n)."""
    n = H.shape[-1]
    cols = [H[..., j] for j in range(n)]
    qs = []
    R = [[None] * n for _ in range(n)]
    for j in range(n):
        v = cols[j]
        for i in range(j):
            r = torch.sum(qs[i] * v, dim=-1, keepdim=True)
            R[i][j] = r
            v = v - r * qs[i]
        nrm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-30)
        R[j][j] = nrm
        qs.append(v / nrm)
    bq = [torch.sum(qs[i] * y, dim=-1, keepdim=True) for i in range(n)]
    x = [None] * n
    for j in range(n - 1, -1, -1):
        acc = bq[j]
        for k in range(j + 1, n):
            acc = acc - R[j][k] * x[k]
        x[j] = acc / R[j][j]
    return torch.cat(x, dim=-1)


def anderson(f, x0, m: int = 5, lam: float = 1e-6, max_steps: int = 10,
             beta: float = 0.8) -> Tuple[torch.Tensor, FPInfo]:
    """Anderson acceleration of the fixed point z = f(z).

    x0: (bsz, ...); f maps (bsz, ...) -> (bsz, ...). Returns (best
    iterate, FPInfo); the error is the relative residual
    |f(z) - z| / (1e-5 + |f(z)|). Exactly `max_steps` iterations run (the
    JAX `tol` is ignored there too)."""
    orig_shape = x0.shape
    bsz = orig_shape[0]
    z0 = x0.reshape(bsz, -1)
    N = z0.shape[1]
    dtype, device = z0.dtype, z0.device

    def ff(z_flat):
        return f(z_flat.reshape(orig_shape)).reshape(bsz, -1)

    X = torch.zeros((bsz, m, N), dtype=dtype, device=device)
    F = torch.zeros((bsz, m, N), dtype=dtype, device=device)
    f0 = ff(z0)
    X[:, 0] = z0
    F[:, 0] = f0
    f1 = ff(f0)
    X[:, 1] = f0
    F[:, 1] = f1

    big = 1e12
    best_err = torch.full((bsz,), big, dtype=dtype, device=device)
    best_step = torch.ones((bsz,), dtype=torch.int32, device=device)
    best_z = X[:, 1].clone()
    final_err = torch.full((bsz,), big, dtype=dtype, device=device)
    eye = torch.eye(m, dtype=dtype, device=device)
    slots = torch.arange(m, device=device)

    for k in range(2, max_steps):
        valid = (slots < min(k, m)).to(dtype)  # (m,)
        G = F - X
        Hb = torch.einsum("bin,bjn->bij", X, G)
        # bordered system [[0, 1_v'], [1_v, Hb_vv]] alpha_ext = e_0, with
        # invalid slots pinned to alpha_j = 0 via identity rows, and a
        # relative jitter on the valid diagonal
        vmask = valid[:, None] * valid[None, :]
        diag_scale = torch.mean(torch.abs(torch.diagonal(Hb, dim1=-2, dim2=-1)),
                                dim=-1)[:, None, None] + 1e-30
        Hb = Hb * vmask + lam * diag_scale * eye * valid[:, None]
        Hb = Hb + eye * (1.0 - valid)[:, None]
        Hfull = torch.zeros((bsz, m + 1, m + 1), dtype=dtype, device=device)
        Hfull[:, 0, 1:] = valid
        Hfull[:, 1:, 0] = valid
        Hfull[:, 1:, 1:] = Hb
        y = torch.zeros((bsz, m + 1), dtype=dtype, device=device)
        y[:, 0] = 1.0
        alpha = _solve_small_qr(Hfull, y)[:, 1:] * valid

        x_new = (beta * torch.einsum("bm,bmn->bn", alpha, F)
                 + (1 - beta) * torch.einsum("bm,bmn->bn", alpha, X))
        f_new = ff(x_new)
        slot = k % m
        X[:, slot] = x_new
        F[:, slot] = f_new

        err = (torch.linalg.vector_norm(f_new - x_new, dim=1)
               / (1e-5 + torch.linalg.vector_norm(f_new, dim=1)))
        improved = err < best_err
        best_z = torch.where(improved[:, None], x_new, best_z)
        best_err = torch.where(improved, err, best_err)
        best_step = torch.where(improved, torch.full_like(best_step, k), best_step)
        final_err = err
    info = FPInfo(best_err=best_err, best_step=best_step, final_err=final_err)
    return best_z.reshape(orig_shape), info
