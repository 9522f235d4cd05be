"""Cartpole n-link environments (1-link nx = 4, 2-link nx = 6).

Port of `deqmpc_tpu/envs/cartpole.py:35-223`: a cart of mass `mc` sliding
on x with `n_links` point masses at the link tips, relative joint angles,
0 rad = upright, and a force on the cart as the only actuation. The
manipulator equation M(q) qdd + h(q, qd) = tau is assembled from a
closed-form mass matrix (tip-Jacobian cumsum identities) and one
forward-mode Jacobian of it for the velocity-product terms; the 1-link
case (config #2) takes the closed-form acceleration `_accel_1l` instead,
which is the same algebra. Constants as in JAX: u_bounds 100 / 250,
episode length 200 / 300, Qlqr ones, Rlqr 1e-10.

The 1-link dynamics broadcast over leading dims. The n-link ones are
written for one sample (the mass matrix's Jacobian is per sample) and
lifted with `torch.func.vmap`. Elements are taken as slices (`q[..., 1:2]`),
never as 0-dim tensors: the card's `torch.func` forward mode promotes a
0-dim float32 times a Python float to float64.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import resolve_device
from ..utils.rotations import angle_normalize_2pi, rk4
from .base import Env, Spaces


def _solve_spd_small(M, b):
    """Solve a small SPD system (n <= 3) by Cramer's rule, as the JAX
    package does (`cartpole.py:35-68`), so the rounding is the same. M
    (..., n, n), b (..., n)."""
    n = M.shape[-1]
    if n == 1:
        return b / M[..., 0, :]
    if n == 2:
        a, c, d = M[..., 0, 0:1], M[..., 0, 1:2], M[..., 1, 1:2]
        b0, b1 = b[..., 0:1], b[..., 1:2]
        det = a * d - c * c
        return torch.cat([(d * b0 - c * b1) / det, (a * b1 - c * b0) / det], dim=-1)
    if n == 3:
        m00, m01, m02 = M[..., 0, 0:1], M[..., 0, 1:2], M[..., 0, 2:3]
        m11, m12, m22 = M[..., 1, 1:2], M[..., 1, 2:3], M[..., 2, 2:3]
        c00 = m11 * m22 - m12 * m12
        c01 = m02 * m12 - m01 * m22
        c02 = m01 * m12 - m02 * m11
        c11 = m00 * m22 - m02 * m02
        c12 = m01 * m02 - m00 * m12
        c22 = m00 * m11 - m01 * m01
        det = m00 * c00 + m01 * c01 + m02 * c02
        b0, b1, b2 = b[..., 0:1], b[..., 1:2], b[..., 2:3]
        return torch.cat([(c00 * b0 + c01 * b1 + c02 * b2) / det,
                          (c01 * b0 + c11 * b1 + c12 * b2) / det,
                          (c02 * b0 + c12 * b1 + c22 * b2) / det], dim=-1)
    return torch.linalg.solve(M, b)


class CartpoleEnv(Env):
    def __init__(self, nx: int = 4, dt: float = 0.05, stabilization: bool = False,
                 mc: float = 1.0, mp: float = 0.1, length: float = 0.5, g: float = 9.81):
        assert nx % 2 == 0 and nx >= 4
        self.nx = nx
        self.nq = nx // 2
        self.nu = 1
        self.n_links = self.nq - 1
        self.dt = dt
        self.mc, self.mp, self.length, self.g = mc, mp, length, g
        self.stabilization = stabilization
        self.spec_id = "Cartpole{}l-v0{}".format(self.n_links,
                                                 "-stabilize" if stabilization else "")
        self.T, self.u_bounds = (300, 250.0) if nx == 6 else (200, 100.0)
        self._max_episode_steps = self.T
        high = np.concatenate([np.full(self.nq, np.pi), np.full(self.nq, np.pi * 5)])
        self.observation_space = Spaces(-high, high)
        self.action_space = Spaces(np.full(self.nu, -self.u_bounds),
                                   np.full(self.nu, self.u_bounds))
        self.Qlqr = np.ones(self.nx, dtype=np.float64)
        self.Rlqr = np.full(self.nu, 1e-10, dtype=np.float64)
        self.targ_pos = np.zeros(self.nx)
        # static masks of the tip Jacobians: L[i, j] = [j <= i], U[j, k] = [j >= k]
        n = self.n_links
        self._L = np.tril(np.ones((n, n)))
        self._U = np.tril(np.ones((n, n)))
        self._E00 = np.zeros((self.nq, self.nq))
        self._E00[0, 0] = 1.0
        self._w = np.arange(n, 0, -1, dtype=np.float64)  # tips at or beyond link j

    # -- closed-form manipulator quantities (one sample) ------------------------
    def _tip_jacobians(self, q):
        """d p_i / d q for every tip i, (n_links, 2, nq): with absolute
        angles a = cumsum(theta), d(tip_i_x)/d theta_k = l * sum_{k<=j<=i}
        cos a_j (and -sin for y)."""
        a = torch.cumsum(q[1:], dim=0)
        Lm, Um = self._const("_L", q), self._const("_U", q)
        Bx = self.length * (Lm * torch.cos(a)[None, :]) @ Um
        By = self.length * (Lm * torch.sin(a)[None, :]) @ Um
        n = self.n_links
        Jx = torch.cat([torch.ones((n, 1), dtype=q.dtype, device=q.device), Bx], dim=1)
        Jy = torch.cat([torch.zeros((n, 1), dtype=q.dtype, device=q.device), -By], dim=1)
        return torch.stack([Jx, Jy], dim=1)

    def _mass_matrix(self, q):
        J = self._tip_jacobians(q)
        M = self.mp * torch.einsum("ndk,ndl->kl", J, J)
        return M + self.mc * self._const("_E00", q)

    def _dV_dq(self, q):
        """Gravity gradient: V = mp g l sum_j w_j cos(a_j), w_j the tips at
        or beyond link j; dV/dtheta_k = -mp g l sum_{j>=k} w_j sin(a_j)."""
        a = torch.cumsum(q[1:], dim=0)
        s = self._const("_w", q) * torch.sin(a)
        dtheta = -self.mp * self.g * self.length * torch.flip(
            torch.cumsum(torch.flip(s, [0]), dim=0), [0])
        return torch.cat([torch.zeros(1, dtype=q.dtype, device=q.device), dtheta])

    def _accel_1l(self, q, qd, u):
        """Closed-form 1-link acceleration (nq = 2), broadcasting:
        M = [[mc+mp, mp l c], [mp l c, mp l^2]],
        rhs = [u + mp l s thd^2, mp g l s]."""
        th, thd = q[..., 1:2], qd[..., 1:2]
        mc, mp, l, g = self.mc, self.mp, self.length, self.g
        s, c = torch.sin(th), torch.cos(th)
        a_ = mc + mp
        b_ = mp * l * c
        d_ = mp * l * l
        r0 = u[..., 0:1] + mp * l * s * thd * thd
        r1 = mp * g * l * s
        det = a_ * d_ - b_ * b_
        return torch.cat([(d_ * r0 - b_ * r1) / det, (a_ * r1 - b_ * r0) / det], dim=-1)

    def _accel(self, q, qd, u):
        """The n-link acceleration of one sample (q, qd (nq,), u (1,))."""
        M = self._mass_matrix(q)
        dMdq = jacfwd(self._mass_matrix)(q)  # (nq, nq, nq)
        Mdot_qd = torch.einsum("ijk,j,k->i", dMdq, qd, qd)
        dT_dq = 0.5 * torch.einsum("jki,j,k->i", dMdq, qd, qd)
        h = Mdot_qd - dT_dq + self._dV_dq(q)
        tau = torch.cat([u[0:1], torch.zeros(self.nq - 1, dtype=q.dtype, device=q.device)])
        return _solve_spd_small(M, tau - h)

    def _xdot(self, state, u):
        q, qd = state[..., : self.nq], state[..., self.nq:]
        accel = self._accel_1l if self.nq == 2 else self._accel
        return torch.cat([qd, accel(q, qd, u)], dim=-1)

    def dynamics(self, x, u):
        if self.nq == 2:
            return rk4(self._xdot, x, u, self.dt)
        lead = x.shape[:-1]
        step = vmap(lambda xi, ui: rk4(self._xdot, xi, ui, self.dt))
        return step(x.reshape(-1, self.nx), u.reshape(-1, self.nu)).reshape(*lead, self.nx)

    # -- gym API ----------------------------------------------------------------
    def state_clip(self, x):
        """Joint angles wrapped into [0, 2 pi)."""
        angles = angle_normalize_2pi(x[..., 1: self.nq])
        return torch.cat([x[..., :1], angles, x[..., self.nq:]], dim=-1)

    def reward(self, x, u):
        theta = x[..., 1: self.nq]
        delta = torch.minimum(torch.abs(theta), torch.abs(theta - 2 * math.pi)).sum(dim=-1)
        px = torch.abs(x[..., 0])
        return -(delta + px + (px > 10).to(x.dtype) * 80.0)

    def reset(self, generator, bsz, device="cuda", dtype=torch.float32):
        if self.stabilization:
            high = np.full(self.nx, 0.05)
        else:
            high = np.concatenate([np.full(self.nq, np.pi), np.full(self.nq, 0.5)])
            high[0] = 1.0
        x = self.state_clip(self._uniform(generator, bsz, -high, high))
        return x.to(device=resolve_device(device), dtype=dtype)


class Cartpole2linkEnv(CartpoleEnv):
    def __init__(self, dt: float = 0.03, stabilization: bool = False, **kw):
        super().__init__(nx=6, dt=dt, stabilization=stabilization, **kw)
