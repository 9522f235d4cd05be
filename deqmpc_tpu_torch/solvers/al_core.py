"""Augmented-Lagrangian math core: residuals, merit, block KKT assembly.

Port of `deqmpc_tpu/solvers/al_core.py:33-289`. The gradient J'lam and
the Hessian blocks of diag(Q) + rho*J'J are assembled directly from the
per-step dynamics Jacobians, so the Newton system stays
block-tridiagonal for `ops.block_tridiag_solve`.

Constraint ordering (as in the JAX package):
  equality rows  : defects r_t = x_{t+1} - f(x_t, u_t) for t = 0..T-2,
                   then the initial-state row x_0 - x0;
  inequality rows: per step t, [u_t - u_hi ; u_lo - u_t] (2*nu rows),
                   then, with an `ObstacleSet`, per step t the rows
                   radius^2 - |xyz_t - o_k|^2 of its n_sel selected
                   spheres.
Duals `lam` are flat: [eq (T*nx) | u-box (T*2*nu) | obstacles (T*n_sel)].

The state-estimator (MHE, moving-horizon estimation) flavour,
`state_estimator=True` (`al_core.py:58-64,184-231`): no initial-state row
(a zero row in its slot keeps the shapes), no control box (pass u_lower
None), and no S'S on block 0 of the Hessian.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F_nn


class ObstacleSet(NamedTuple):
    """The obstacle centers selected per (sample, step), (bsz, T, n_sel, 3),
    and the spheres' common radius. `ALMPC` also holds the whole field in
    one, with centers (N, 3)."""

    centers: torch.Tensor
    radius: float


# --------------------------------------------------------------------------
# residuals
# --------------------------------------------------------------------------

def eq_residuals(dyn, x, u, x0):
    """Equality residuals (bsz, T, nx): rows 0..T-2 are dynamics defects,
    row T-1 is the initial-state residual."""
    defects = x[:, 1:] - dyn(x[:, :-1], u[:, :-1])
    return torch.cat([defects, (x[:, 0] - x0)[:, None]], dim=1)


def eq_residuals_se(dyn, x, u, x0):
    """The state-estimator flavour: the defects, then a zero row in place of
    the initial-state residual."""
    defects = x[:, 1:] - dyn(x[:, :-1], u[:, :-1])
    return torch.cat([defects, torch.zeros_like(defects[:, :1])], dim=1)


def ineq_residuals(u, u_lower, u_upper):
    """Control box rows per step: [u - u_hi ; u_lo - u]. Returns
    (res, res_clamp), each (bsz, T, 2*nu)."""
    res = torch.cat([u - u_upper, u_lower - u], dim=-1)
    return res, torch.clamp(res, min=0.0)


def obstacle_residuals(x, obs: ObstacleSet):
    """Sphere rows radius^2 - |xyz - center|^2 <= 0. Returns (res,
    res_clamp), each (bsz, T, n_sel)."""
    d2 = torch.sum((x[..., None, :3] - obs.centers) ** 2, dim=-1)
    res = obs.radius**2 - d2
    return res, torch.clamp(res, min=0.0)


def full_residuals(dyn, x, u, x0, u_lower, u_upper, obs=None, state_estimator=False):
    """All residuals, flattened: (res, res_clamp), each (bsz, ncon). No
    control-box rows when u_lower is None."""
    bsz = x.shape[0]
    r_eq = (eq_residuals_se if state_estimator else eq_residuals)(dyn, x, u, x0).reshape(bsz, -1)
    parts, parts_c = [r_eq], [r_eq]
    if u_lower is not None:
        r_in, r_in_c = ineq_residuals(u, u_lower, u_upper)
        parts.append(r_in.reshape(bsz, -1))
        parts_c.append(r_in_c.reshape(bsz, -1))
    if obs is not None:
        r_o, r_o_c = obstacle_residuals(x, obs)
        parts.append(r_o.reshape(bsz, -1))
        parts_c.append(r_o_c.reshape(bsz, -1))
    return torch.cat(parts, dim=1), torch.cat(parts_c, dim=1)


# --------------------------------------------------------------------------
# cost & merit
# --------------------------------------------------------------------------

def compute_cost(xu, Q, q):
    """Diagonal quadratic cost per sample (the constant f is left out)."""
    return torch.sum(0.5 * xu * Q * xu + q * xu, dim=(-2, -1))


def merit_function(dyn, xu, Q, q, x0, lam, rho, u_lower, u_upper, obs=None,
                   state_estimator=False):
    """L = cost + 0.5*rho*|res_clamp|^2 + lam'res.
    Shapes: xu (bsz, T, n); rho (bsz, 1); lam (bsz, ncon)."""
    nx = x0.shape[-1]
    res, res_c = full_residuals(dyn, xu[..., :nx], xu[..., nx:], x0,
                                u_lower, u_upper, obs, state_estimator)
    return (compute_cost(xu, Q, q)
            + 0.5 * rho[:, 0] * torch.sum(res_c * res_c, dim=1)
            + torch.sum(lam * res, dim=1))


# --------------------------------------------------------------------------
# structured gradient + block-tridiagonal Gauss-Newton Hessian
# --------------------------------------------------------------------------

def merit_grad_blocks(xu, Q, q, x0, lam, rho, F, u_lower, u_upper, dyn_eq_res,
                      obs=None, state_estimator=False):
    """Merit gradient and GN Hessian in block-tridiagonal form.

    xu: (bsz, T, n); F: dynamics Jacobians [A_t B_t] (bsz, T-1, nx, n);
    dyn_eq_res: the stacked eq residuals (bsz, T, nx), computed by the
    caller alongside F. Returns g (bsz, T, n), D (bsz, T, n, n),
    O (bsz, T-1, n, n), res and res_clamp (bsz, ncon). With `obs`, the
    obstacle rows add their gradient on the xyz part of each block and,
    where active, rho J_o'J_o on its 3x3. With `state_estimator` there is
    no initial-state row and block 0 gets no S'S; u_lower None means no
    control-box rows."""
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
        if state_estimator:
            return out
        # the initial-state row (stored at slot T-1) acts on block 0
        return out + F_nn.pad(v_eq[:, T - 1][:, None], (0, nu, 0, T - 1))

    g = g + eq_terms(lam_eq) + eq_terms(rho[..., None] * r_eq)
    res_parts = [r_eq.reshape(bsz, -1)]
    res_c_parts = [r_eq.reshape(bsz, -1)]
    off = T * nx

    if u_lower is not None:
        r_in, r_in_c = ineq_residuals(u, u_lower, u_upper)
        lam_in = lam[:, off: off + T * 2 * nu].reshape(bsz, T, 2 * nu)
        off += T * 2 * nu
        # rows [u - u_hi] have +I_u, rows [u_lo - u] have -I_u
        gu = (lam_in[..., :nu] - lam_in[..., nu:]) + rho[..., None] * (
            r_in_c[..., :nu] - r_in_c[..., nu:])
        g = g + F_nn.pad(gu, (nx, 0))
        active_u = (r_in >= 0).to(dtype)
        res_parts.append(r_in.reshape(bsz, -1))
        res_c_parts.append(r_in_c.reshape(bsz, -1))

    if obs is not None:
        r_o, r_o_c = obstacle_residuals(xu[..., :nx], obs)  # (bsz, T, n_sel)
        res_parts.append(r_o.reshape(bsz, -1))
        res_c_parts.append(r_o_c.reshape(bsz, -1))
        n_sel = r_o.shape[-1]
        lam_o = lam[:, off: off + T * n_sel].reshape(bsz, T, n_sel)
        jac_obs = -2.0 * (xu[..., None, :3] - obs.centers)  # (bsz, T, n_sel, 3)
        active_obs = (r_o >= 0).to(dtype)
        go = (torch.einsum("btk,btkj->btj", lam_o, jac_obs)
              + rho[..., None] * torch.einsum("btk,btkj->btj", r_o_c * active_obs, jac_obs))
        g = g + F_nn.pad(go, (0, n - 3))

    # ----- Hessian blocks: diag(Q) + rho * J_c'J_c ------------------------
    eye_x = torch.cat([torch.ones(nx, dtype=dtype, device=device),
                       torch.zeros(nu, dtype=dtype, device=device)])
    rho4 = rho[..., None, None]
    D = torch.diag_embed(Q)
    # S'S (identity on the x-part) once per block: from the defect row t-1
    # for t >= 1, from the initial-state row for t = 0, which the state
    # estimator does not have
    if state_estimator:
        D = D + rho4 * F_nn.pad(torch.diag(eye_x).expand(T - 1, n, n), (0, 0, 0, 0, 1, 0))
    else:
        D = D + rho4 * torch.diag(eye_x)
    # F_t'F_t on blocks 0..T-2
    FtF = torch.einsum("btik,btil->btkl", F, F)
    D = D + rho4 * F_nn.pad(FtF, (0, 0, 0, 0, 0, 1))
    if u_lower is not None:
        # active control-box rows: diagonal on the u-part
        act = active_u[..., :nu] + active_u[..., nu:]
        D = D + rho4 * torch.diag_embed(F_nn.pad(act, (nx, 0)))
    # active obstacle rows: a 3x3 on the xyz part
    if obs is not None:
        JoJo = torch.einsum("btk,btki,btkj->btij", active_obs, jac_obs, jac_obs)
        D = D + rho4 * F_nn.pad(JoJo, (0, n - 3, 0, n - 3))

    # super-diagonal: block (t, t+1) = -rho * F_t' S = [-rho F_t' | 0]
    O = F_nn.pad(-rho4 * F.mT, (0, nu))

    return g, D, O, torch.cat(res_parts, dim=1), torch.cat(res_c_parts, dim=1)


def num_constraints(T: int, nx: int, nu: int, n_obs_sel: int = 0,
                    has_u_box: bool = True) -> int:
    """Constraint count: T*nx eq rows (the state estimator's zero row
    included), 2*nu*T control-box rows when there is a box and n_obs_sel*T
    obstacle rows."""
    return T * nx + (2 * nu * T if has_u_box else 0) + n_obs_sel * T
