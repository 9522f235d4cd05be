"""Fixed-point solvers of the DEQ layer: Anderson, its cost-aware
flavour and good Broyden.

Port of `anderson`, `anderson_jiio` and `broyden`
(`deqmpc_tpu/solvers/fp.py:30-313`) with the JAX semantics: each runs
exactly its fixed number of iterations and has no `tol` (JAX ignores it,
`fp.py:79-86`), and tracks each sample's best iterate with masks.
Anderson solves the (m+1)x(m+1) bordered mixing system with the unrolled
modified-Gram-Schmidt QR of `fp.py:36-68`, with unfilled slots pinned to
identity rows so their weights are exactly zero; `anderson_jiio` mixes
the same way and accepts an iterate on the residual, in warmup, or on
the cost within 1.3x of the best residual. Broyden keeps a low-rank
Sherman-Morrison estimate of the inverse Jacobian of g(z) = f(z) - z
with `max_steps` slots, guards its denominator at 1e-30 and zeroes the
non-finite entries of each rank-1 pair (`jnp.nan_to_num`: NaN to 0, +-inf
to the dtype's largest finite value), in JAX's order. The history
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


def _rel_err(f_new, x_new):
    return (torch.linalg.vector_norm(f_new - x_new, dim=1)
            / (1e-5 + torch.linalg.vector_norm(f_new, dim=1)))


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

    for k in range(2, max_steps):
        x_new = _mix(_mixing_weights(X, F, k, m, lam), X, F, beta)
        f_new = ff(x_new)
        slot = k % m
        X[:, slot] = x_new
        F[:, slot] = f_new

        err = _rel_err(f_new, x_new)
        improved = err < best_err
        best_z = torch.where(improved[:, None], x_new, best_z)
        best_err = torch.where(improved, err, best_err)
        best_step = torch.where(improved, torch.full_like(best_step, k), best_step)
        final_err = err
    info = FPInfo(best_err=best_err, best_step=best_step, final_err=final_err)
    return best_z.reshape(orig_shape), info


def anderson_jiio(f, x0, m: int = 5, lam: float = 1e-6, max_steps: int = 50,
                  beta: float = 0.8, warmup: int = 10) -> Tuple[torch.Tensor, FPInfo]:
    """The JIIO flavour of Anderson (`fp.py:166-249`): f(z, k) returns (the
    next iterate, a per-sample cost (bsz,)). The best iterate is accepted
    where the relative residual improves, while k < warmup, or where the
    cost improves with the residual within 1.3x of the best; best_err
    follows the residual alone. Exactly `max_steps` iterations run."""
    orig_shape = x0.shape
    bsz = orig_shape[0]
    z0 = x0.reshape(bsz, -1)
    N = z0.shape[1]
    dtype, device = z0.dtype, z0.device

    def ff(z_flat, k):
        out, cost = f(z_flat.reshape(orig_shape), k)
        return out.reshape(bsz, -1), cost

    X = torch.zeros((bsz, m, N), dtype=dtype, device=device)
    F = torch.zeros((bsz, m, N), dtype=dtype, device=device)
    f0, _ = ff(z0, 0)
    X[:, 0] = z0
    F[:, 0] = f0
    f1, best_cost = ff(f0, 1)
    X[:, 1] = f0
    F[:, 1] = f1
    big = 1e12
    best_err = torch.full((bsz,), big, dtype=dtype, device=device)
    best_z = X[:, 1].clone()
    best_step = torch.ones((bsz,), dtype=torch.int32, device=device)
    final_err = torch.full((bsz,), big, dtype=dtype, device=device)

    for k in range(2, max_steps):
        x_new = _mix(_mixing_weights(X, F, k, m, lam), X, F, beta)
        f_new, cost = ff(x_new, k)
        slot = k % m
        X[:, slot] = x_new
        F[:, slot] = f_new
        err = _rel_err(f_new, x_new)
        improved = err < best_err
        accept = improved | (k < warmup) | ((cost < best_cost) & (err < 1.3 * best_err))
        best_z = torch.where(accept[:, None], x_new, best_z)
        best_cost = torch.where(accept, cost, best_cost)
        best_step = torch.where(accept, torch.full_like(best_step, k), best_step)
        best_err = torch.where(improved, err, best_err)
        final_err = err
    info = FPInfo(best_err=best_err, best_step=best_step, final_err=final_err)
    return best_z.reshape(orig_shape), info


def broyden(f, x0, max_steps: int = 20, stop_mode: str = "abs") -> Tuple[torch.Tensor, FPInfo]:
    """Good Broyden for the root of g(z) = f(z) - z (`fp.py:252-313`):
    update = -(-I + U V') g, a rank-1 Sherman-Morrison pair per step in slot
    k mod max_steps, u = (dz - (-I + U V') dg) / (dg'dg) with the
    denominator replaced by 1 below 1e-30, both of the pair through
    `nan_to_num`. The error is |g| ("abs", the default) or |g| / (1e-5 +
    |z|) ("rel"); best_step counts from 1 (the iterate after step k is
    k + 1), 0 keeping x0. Exactly `max_steps` steps run."""
    orig_shape = x0.shape
    bsz = orig_shape[0]
    z = x0.reshape(bsz, -1)
    N = z.shape[1]
    dtype, device = z.dtype, z.device
    L = max_steps  # the low-rank memory

    def gg(z_flat):
        return f(z_flat.reshape(orig_shape)).reshape(bsz, -1) - z_flat

    slots = torch.arange(L, device=device)

    def matvec(Us, VTs, x, nstep):
        """(-I + U V') x with only the first `nstep` rank-1 terms."""
        VTx = torch.einsum("bdn,bn->bd", VTs, x) * (slots < nstep).to(dtype)
        return -x + torch.einsum("bnd,bd->bn", Us, VTx)

    gx = gg(z)
    Us = torch.zeros((bsz, N, L), dtype=dtype, device=device)
    VTs = torch.zeros((bsz, L, N), dtype=dtype, device=device)
    best_err = torch.linalg.vector_norm(gx, dim=1)
    best_z = z
    best_step = torch.zeros((bsz,), dtype=torch.int32, device=device)
    final_err = best_err
    for k in range(max_steps):
        z_new = z - matvec(Us, VTs, gx, k)
        gx_new = gg(z_new)
        delta_z = z_new - z
        delta_g = gx_new - gx
        denom = torch.einsum("bn,bn->b", delta_g, delta_g)[:, None]
        u = (delta_z - matvec(Us, VTs, delta_g, k)) / torch.where(
            torch.abs(denom) < 1e-30, torch.ones_like(denom), denom)
        slot = k % L
        Us[:, :, slot] = torch.nan_to_num(u)
        VTs[:, slot] = torch.nan_to_num(delta_g)
        err = torch.linalg.vector_norm(gx_new, dim=1)
        if stop_mode == "rel":
            err = err / (1e-5 + torch.linalg.vector_norm(z_new, dim=1))
        improved = err < best_err
        best_z = torch.where(improved[:, None], z_new, best_z)
        best_err = torch.where(improved, err, best_err)
        best_step = torch.where(improved, torch.full_like(best_step, k + 1), best_step)
        final_err = err
        z, gx = z_new, gx_new
    info = FPInfo(best_err=best_err, best_step=best_step, final_err=final_err)
    return best_z.reshape(orig_shape), info
