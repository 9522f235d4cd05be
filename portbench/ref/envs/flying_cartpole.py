"""FlyingCartpole: a quadrotor carrying an inverted pendulum (14-D state).

As `deqmpc_tpu/envs/flying_cartpole.py:25-138` without obstacles: state x = [r(3),
p(3 MRP), theta, v(3 body), w(3 body), thetadot]; 4 throttles offset
around hover (u_actual = act_scale * (u + u_hover)); the pole is driven
by the world-frame x-acceleration, theta_dd = (g_z sin(theta) + x_dd
cos(theta)) / L; the upright target is theta = pi. The blocks of the
Newton system are n = nx + nu = 18.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.rotations import (angle_normalize_2pi, euler_to_quaternion, mrp2quat,
                               quat2mrp, quatrot, rk4, w2pdotkinematics_mrp)
from .base import Env, Spaces


class FlyingCartpole(Env):
    def __init__(self, Qscale: float = 1.0, mass_q: float = 2.0, mass_p: float = 0.1,
                 J=((0.0023, 0.0, 0.0), (0.0, 0.0023, 0.0), (0.0, 0.0, 0.004)),
                 L: float = 0.5, gravity=(0.0, 0.0, -9.81), motor_dist: float = 0.175,
                 kf: float = 1.0, km: float = 0.025, dt: float = 0.05):
        self.nx, self.nu, self.nq = 14, 4, 7
        self.dt = dt
        self.mass = mass_q + mass_p
        self.L = L
        self.J = np.asarray(J, dtype=np.float64)
        self.Jinv = np.linalg.inv(self.J)
        self.gvec = np.asarray(gravity, dtype=np.float64)
        self.mass_g = self.mass * self.gvec
        self.e_z = np.array([0.0, 0.0, 1.0])
        self.motor_dist = motor_dist
        self.kf, self.km = kf, km
        self.act_scale = 10.0
        self.u_hover = float(-self.mass * gravity[2] / self.act_scale / kf / 4)
        ss = np.array([[1.0, 1, 0], [1.0, -1, 0], [-1.0, -1, 0], [-1.0, 1, 0]])
        self.ss = ss / np.linalg.norm(ss, axis=-1, keepdims=True)
        self.arms = motor_dist * self.ss
        self.Qlqr = np.array([10.0] * 3 + [10.0] * 3 + [80.0] + [1.0 * Qscale] * 6
                             + [1.0 * Qscale], dtype=np.float64)
        self.Rlqr = np.full(4, 1e-8, dtype=np.float64)
        ub = 0.3 * self.u_hover
        self.action_space = Spaces(np.full(4, -ub), np.full(4, ub))
        self.x_window = np.array([5.0, 5.0, 5.0] + [np.deg2rad(45)] * 3 + [np.pi] + [1.0] * 7)
        self.targ_pos = np.zeros(14)
        self.targ_pos[6] = np.pi  # upright pendulum

    # -- continuous-time physics ---------------------------------------------
    def _xdot(self, x, u):
        u = self.act_scale * (u + self.u_hover)
        p, theta, v, w = x[..., 3:6], x[..., 6:7], x[..., 7:10], x[..., 10:13]
        thetadot = x[..., 13:14]
        q = mrp2quat(p)
        # rotor thrust along body z plus gravity rotated into the body frame
        thrust = self.kf * torch.sum(u, dim=-1, keepdim=True)
        F = self._const("e_z", x) * thrust + quatrot(mrp2quat(-p), self._const("mass_g", x))
        # yaw from the drag torques, roll and pitch from the motor arms;
        # slices, not 0-dim elements: torch.func's forward mode promotes the
        # tangent of a 0-dim float32 times a Python float to float64
        yaw = self.km * (u[..., 0:1] - u[..., 1:2] + u[..., 2:3] - u[..., 3:4])
        thrust_z = self.kf * u
        zeros = torch.zeros_like(thrust_z)
        thrust_vecs = torch.stack([zeros, zeros, thrust_z], dim=-1)  # (..., 4, 3)
        arms = self._const("arms", x).expand_as(thrust_vecs)
        tau = torch.sum(torch.linalg.cross(arms, thrust_vecs, dim=-1), dim=-2)
        tau = torch.cat([tau[..., :2], tau[..., 2:] + yaw], dim=-1)

        rdot = quatrot(q, v)
        pdot = w2pdotkinematics_mrp(p, w)
        vdot = F / self.mass - torch.linalg.cross(w, v, dim=-1)
        Jw = w @ self._const("J", x).mT
        wdot = (tau - torch.linalg.cross(w, Jw, dim=-1)) @ self._const("Jinv", x).mT
        # the pole: the world-frame x-acceleration drives it
        x_dd = quatrot(q, vdot)[..., 0:1]
        theta_dd = (float(self.gvec[2]) * torch.sin(theta) + x_dd * torch.cos(theta)) / self.L
        return torch.cat([rdot, pdot, thetadot, vdot, wdot, theta_dd], dim=-1)

    def dynamics(self, x, u):
        return rk4(self._xdot, x, u, self.dt)

    # -- gym API --------------------------------------------------------------
    def state_clip(self, x):
        return torch.cat([x[..., :6], angle_normalize_2pi(x[..., 6:7]), x[..., 7:]], dim=-1)

    def reward(self, x, u):
        cost = torch.sum((x - self._const("targ_pos", x)) ** 2 * self._const("Qlqr", x) / 2,
                         dim=-1) / 100
        cost = cost + torch.sum(u**2 * self._const("Rlqr", u) / 2, dim=-1) / 10
        return torch.exp(-cost / 2 + 2)

    def reset(self, generator, bsz, device="cuda", dtype=torch.float32):
        """Uniform start in the Euler-space window (`flying_cartpole.py:118-128`)."""
        w = np.asarray(self.x_window, dtype=np.float64)
        x = self._uniform(generator, bsz, -w, w)
        mrp = quat2mrp(euler_to_quaternion(x[:, 3:6]))
        x = torch.cat([x[:, :3], mrp, math.pi + x[:, 6:7], x[:, 7:]], dim=-1)
        return x.to(device=torch.device(device), dtype=dtype)
