"""Augmented-Lagrangian math core: residuals, merit, block KKT assembly.

Port of `deqmpc_tpu/solvers/al_core.py:48-289`. The gradient J'lam and
the Hessian blocks of diag(Q) + rho*J'J are assembled directly from the
per-step dynamics Jacobians, so the Newton system stays
block-tridiagonal for `ops.block_tridiag_solve`.

Constraint ordering (as in the JAX package):
  equality rows  : defects r_t = x_{t+1} - f(x_t, u_t) for t = 0..T-2,
                   then the initial-state row x_0 - x0;
  inequality rows: per step t, [u_t - u_hi ; u_lo - u_t] (2*nu rows).
Duals `lam` are flat: [eq (T*nx) | ineq (T*2*nu)]. Obstacle rows and
the state-estimator variant are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F_nn


def _no_obstacles(obs):
    if obs is not None:
        raise NotImplementedError("obstacle constraint rows are not ported yet")


# --------------------------------------------------------------------------
# residuals
# --------------------------------------------------------------------------

def eq_residuals(dyn, x, u, x0):
    """Equality residuals (bsz, T, nx): rows 0..T-2 are dynamics defects,
    row T-1 is the initial-state residual."""
    defects = x[:, 1:] - dyn(x[:, :-1], u[:, :-1])
    return torch.cat([defects, (x[:, 0] - x0)[:, None]], dim=1)


def ineq_residuals(u, u_lower, u_upper):
    """Control box rows per step: [u - u_hi ; u_lo - u]. Returns
    (res, res_clamp), each (bsz, T, 2*nu)."""
    res = torch.cat([u - u_upper, u_lower - u], dim=-1)
    return res, torch.clamp(res, min=0.0)


def full_residuals(dyn, x, u, x0, u_lower, u_upper, obs=None):
    """All residuals, flattened: (res, res_clamp), each (bsz, ncon)."""
    _no_obstacles(obs)
    bsz = x.shape[0]
    r_eq = eq_residuals(dyn, x, u, x0).reshape(bsz, -1)
    r_in, r_in_c = ineq_residuals(u, u_lower, u_upper)
    return (torch.cat([r_eq, r_in.reshape(bsz, -1)], dim=1),
            torch.cat([r_eq, r_in_c.reshape(bsz, -1)], dim=1))


# --------------------------------------------------------------------------
# cost & merit
# --------------------------------------------------------------------------

def compute_cost(xu, Q, q):
    """Diagonal quadratic cost per sample (the constant f is left out)."""
    return torch.sum(0.5 * xu * Q * xu + q * xu, dim=(-2, -1))


def merit_function(dyn, xu, Q, q, x0, lam, rho, u_lower, u_upper, obs=None):
    """L = cost + 0.5*rho*|res_clamp|^2 + lam'res.
    Shapes: xu (bsz, T, n); rho (bsz, 1); lam (bsz, ncon)."""
    nx = x0.shape[-1]
    res, res_c = full_residuals(dyn, xu[..., :nx], xu[..., nx:], x0,
                                u_lower, u_upper, obs)
    return (compute_cost(xu, Q, q)
            + 0.5 * rho[:, 0] * torch.sum(res_c * res_c, dim=1)
            + torch.sum(lam * res, dim=1))


# --------------------------------------------------------------------------
# structured gradient + block-tridiagonal Gauss-Newton Hessian
# --------------------------------------------------------------------------

def merit_grad_blocks(xu, Q, q, x0, lam, rho, F, u_lower, u_upper, dyn_eq_res,
                      obs=None):
    """Merit gradient and GN Hessian in block-tridiagonal form.

    xu: (bsz, T, n); F: dynamics Jacobians [A_t B_t] (bsz, T-1, nx, n);
    dyn_eq_res: the stacked eq residuals (bsz, T, nx), computed by the
    caller alongside F. Returns g (bsz, T, n), D (bsz, T, n, n),
    O (bsz, T-1, n, n), res and res_clamp (bsz, ncon)."""
    _no_obstacles(obs)
    bsz, T, n = xu.shape
    nx = x0.shape[-1]
    nu = n - nx
    u = xu[..., nx:]
    dtype, device = xu.dtype, xu.device

    r_eq = dyn_eq_res
    lam_eq = lam[:, : T * nx].reshape(bsz, T, nx)

    # ----- gradient: cost + J'lam + rho * J_c' res_clamp ------------------
    g = Q * xu + q

    def eq_terms(v_eq):
        """J_eq' v for stacked eq duals/residuals v (bsz, T, nx)."""
        # defect row t: -F_t' v_t on block t, +S' v_t on block t+1
        gt = -torch.einsum("btij,bti->btj", F, v_eq[:, : T - 1])
        out = F_nn.pad(gt, (0, 0, 0, 1))
        out = out + F_nn.pad(v_eq[:, : T - 1], (0, nu, 1, 0))
        # the initial-state row (stored at slot T-1) acts on block 0
        return out + F_nn.pad(v_eq[:, T - 1][:, None], (0, nu, 0, T - 1))

    g = g + eq_terms(lam_eq) + eq_terms(rho[..., None] * r_eq)

    r_in, r_in_c = ineq_residuals(u, u_lower, u_upper)
    lam_in = lam[:, T * nx:].reshape(bsz, T, 2 * nu)
    # rows [u - u_hi] have +I_u, rows [u_lo - u] have -I_u
    gu = (lam_in[..., :nu] - lam_in[..., nu:]) + rho[..., None] * (
        r_in_c[..., :nu] - r_in_c[..., nu:])
    g = g + F_nn.pad(gu, (nx, 0))
    active_u = (r_in >= 0).to(dtype)

    # ----- Hessian blocks: diag(Q) + rho * J_c'J_c ------------------------
    eye_x = torch.cat([torch.ones(nx, dtype=dtype, device=device),
                       torch.zeros(nu, dtype=dtype, device=device)])
    rho4 = rho[..., None, None]
    D = torch.diag_embed(Q)
    # S'S (identity on the x-part) once per block
    D = D + rho4 * torch.diag(eye_x)
    # F_t'F_t on blocks 0..T-2
    FtF = torch.einsum("btik,btil->btkl", F, F)
    D = D + rho4 * F_nn.pad(FtF, (0, 0, 0, 0, 0, 1))
    # active control-box rows: diagonal on the u-part
    act = active_u[..., :nu] + active_u[..., nu:]
    D = D + rho4 * torch.diag_embed(F_nn.pad(act, (nx, 0)))

    # super-diagonal: block (t, t+1) = -rho * F_t' S = [-rho F_t' | 0]
    O = F_nn.pad(-rho4 * F.mT, (0, nu))

    res = torch.cat([r_eq.reshape(bsz, -1), r_in.reshape(bsz, -1)], dim=1)
    res_c = torch.cat([r_eq.reshape(bsz, -1), r_in_c.reshape(bsz, -1)], dim=1)
    return g, D, O, res, res_c


def num_constraints(T: int, nx: int, nu: int) -> int:
    """Constraint count: T*nx eq rows and 2*nu*T control-box rows."""
    return T * nx + 2 * nu * T
