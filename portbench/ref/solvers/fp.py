"""Anderson acceleration of the DEQ layer's fixed point, with the JAX
semantics (`deqmpc_tpu/solvers/fp.py`): exactly its fixed number of
iterations, no `tol`, each sample's best iterate tracked with masks. The
(m+1)x(m+1) bordered mixing system is solved by an unrolled
modified-Gram-Schmidt QR, with unfilled slots pinned to identity rows so
their weights are exactly zero. The history buffers are updated in place.
"""
from __future__ import annotations

import torch


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


def _mixing_weights(X, F, k: int, m: int, lam: float):
    """The Anderson weights of iteration k from the history (X, F) (bsz, m,
    N): the bordered system [[0, 1_v'], [1_v, Hb_vv]] alpha_ext = e_0, with
    invalid slots pinned to alpha_j = 0 by identity rows and a relative
    jitter on the valid diagonal."""
    bsz, dtype, device = X.shape[0], X.dtype, X.device
    eye = torch.eye(m, dtype=dtype, device=device)
    valid = (torch.arange(m, device=device) < min(k, m)).to(dtype)  # (m,)
    Hb = torch.einsum("bin,bjn->bij", X, F - X)
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
    return _solve_small_qr(Hfull, y)[:, 1:] * valid


def _mix(alpha, X, F, beta: float):
    return (beta * torch.einsum("bm,bmn->bn", alpha, F)
            + (1 - beta) * torch.einsum("bm,bmn->bn", alpha, X))


def anderson(f, x0, m: int = 5, lam: float = 1e-6, max_steps: int = 10,
             beta: float = 0.8) -> torch.Tensor:
    """The best iterate of Anderson's acceleration of z = f(z) from x0
    (bsz, ...), by the relative residual |f(z) - z| / (1e-5 + |f(z)|).
    Exactly `max_steps` iterations run."""
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

    best_err = torch.full((bsz,), 1e12, dtype=dtype, device=device)
    best_z = X[:, 1].clone()
    for k in range(2, max_steps):
        x_new = _mix(_mixing_weights(X, F, k, m, lam), X, F, beta)
        f_new = ff(x_new)
        slot = k % m
        X[:, slot] = x_new
        F[:, slot] = f_new
        err = (torch.linalg.vector_norm(f_new - x_new, dim=1)
               / (1e-5 + torch.linalg.vector_norm(f_new, dim=1)))
        improved = err < best_err
        best_z = torch.where(improved[:, None], x_new, best_z)
        best_err = torch.where(improved, err, best_err)
    return best_z.reshape(orig_shape)
