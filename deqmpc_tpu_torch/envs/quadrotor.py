"""RexQuadrotor: 12-D quadrotor with MRP attitude and body-frame velocity.

Port of `deqmpc_tpu/envs/quadrotor.py:23-105`: state x = [r(3) world
position, p(3) MRP, v(3) body velocity, w(3) body rates]; 4 rotor
throttles; thrust F_i = kf*u_i + bf along body z; yaw moments km*u with
alternating signs; RK4 integration.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.rotations import (euler_to_quaternion, mrp2quat, quat2mrp,
                               quatrot, rk4, w2pdotkinematics_mrp)
from .. import resolve_device
from .base import Env, Spaces


class RexQuadrotor(Env):
    def __init__(self, mass: float = 2.0,
                 J=((0.01566089, 0.00000318037, 0.0),
                    (0.00000318037, 0.01562078, 0.0),
                    (0.0, 0.0, 0.02226868)),
                 gravity=(0.0, 0.0, -9.81), motor_dist: float = 0.28,
                 kf: float = 0.0244101, bf: float = -30.48576,
                 km: float = 0.00029958,
                 max_steps: int = 100, dt: float = 0.05):
        self.nx, self.nu, self.nq = 12, 4, 7
        self.dt = dt
        self.mass = mass
        self.J = np.asarray(J, dtype=np.float64)
        self.Jinv = np.linalg.inv(self.J)
        self.gvec = np.asarray(gravity, dtype=np.float64)
        self.mass_g = mass * self.gvec
        self.e_z = np.array([0.0, 0.0, 1.0])
        self.kf, self.bf, self.km = kf, bf, km
        self.act_scale = 100.0
        self._max_episode_steps = max_steps
        self.spec_id = "RexQuadrotor-v0"
        # motor positions on the diagonals (unit vectors * motor_dist)
        ss = np.array([[1.0, 1, 0], [1.0, -1, 0], [-1.0, -1, 0], [-1.0, 1, 0]])
        self.arms = motor_dist * ss / np.linalg.norm(ss, axis=-1, keepdims=True)
        self.u_hover = float((-mass * gravity[2] - bf * 4) / self.act_scale / kf / 4)
        self.u_trim = self.u_hover  # the raw rotor command that hovers
        self.Qlqr = np.array([10.0] * 6 + [1.0] * 6, dtype=np.float64)
        self.Rlqr = np.full(4, 1e-8, dtype=np.float64)
        self.action_space = Spaces(np.full(4, 11.5), np.full(4, 18.3))
        self.x_window = np.array(
            [5.0, 5.0, 5.0] + [np.deg2rad(70)] * 3 + [0.5] * 3 + [0.25] * 3
        )
        self.targ_pos = np.zeros(12)

    # -- continuous-time physics ---------------------------------------------
    def _forces(self, p, u):
        """Total body-frame force: rotor thrust (z) plus gravity rotated
        into the body frame."""
        q_inv = mrp2quat(-p)
        thrust = self.kf * torch.sum(u, dim=-1, keepdim=True) + 4.0 * self.bf
        F = self._const("e_z", p) * thrust
        return F + quatrot(q_inv, self._const("mass_g", p))

    def _moments(self, u, x):
        # slices, not 0-dim elements: torch.func's forward mode promotes the
        # tangent of a 0-dim float32 times a Python float to float64
        thrust_z = self.kf * u + self.bf  # per-rotor thrust along body z
        yaw = self.km * (u[..., 0:1] - u[..., 1:2] + u[..., 2:3] - u[..., 3:4])
        zeros = torch.zeros_like(thrust_z)
        # with f32 actions on an f64 state (the MPC teacher) the cross product
        # runs in f64, as JAX's f64 constants make it
        thrust_vecs = torch.stack([zeros, zeros, thrust_z], dim=-1).to(
            torch.promote_types(u.dtype, x.dtype))  # (..., 4, 3)
        arms = self._const("arms", thrust_vecs).expand_as(thrust_vecs)
        tau = torch.sum(torch.linalg.cross(arms, thrust_vecs, dim=-1), dim=-2)
        return torch.cat([tau[..., :2], tau[..., 2:] + yaw], dim=-1)

    def _xdot(self, x, u):
        u = self.act_scale * u
        p, v, w = x[..., 3:6], x[..., 6:9], x[..., 9:12]
        q = mrp2quat(p)
        F = self._forces(p, u)
        tau = self._moments(u, x)
        rdot = quatrot(q, v)
        pdot = w2pdotkinematics_mrp(p, w)
        vdot = F / self.mass - torch.linalg.cross(w, v, dim=-1)
        Jw = w @ self._const("J", x).mT
        wdot = (tau - torch.linalg.cross(w, Jw, dim=-1)) @ self._const("Jinv", x).mT
        return torch.cat([rdot, pdot, vdot, wdot], dim=-1)

    def dynamics(self, x, u):
        return rk4(self._xdot, x, u, self.dt)

    # -- gym API --------------------------------------------------------------
    def reward(self, x, u):
        cost = torch.sum((x - self._const("targ_pos", x)) ** 2
                         * self._const("Qlqr", x) / 2, dim=-1) / 100
        cost = cost + torch.sum(u**2 * self._const("Rlqr", u) / 2, dim=-1) / 10
        return torch.where(cost > 500, -cost, torch.exp(-cost / 2 + 2))

    def is_bad_state(self, x, reward):
        """Also a reward below -500: the cost's far branch (`quadrotor.py:104-105`)."""
        return super().is_bad_state(x, reward) | (reward < -500)

    def reset(self, generator, bsz, device="cuda", dtype=torch.float32, x_window=None):
        """Uniform start in the Euler-space window; `x_window` overrides the
        per-dim half-widths (`quadrotor.py:96-101`)."""
        w = np.asarray(self.x_window if x_window is None else x_window, dtype=np.float64)
        x = self._uniform(generator, bsz, -w, w)
        mrp = quat2mrp(euler_to_quaternion(x[:, 3:6]))
        x = torch.cat([x[:, :3], mrp, x[:, 6:]], dim=-1)
        return x.to(device=resolve_device(device), dtype=dtype)
