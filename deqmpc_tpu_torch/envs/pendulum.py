"""Torque-limited pendulum and the double integrator (port of
`deqmpc_tpu/envs/pendulum.py:25-101`).

theta = 0 hangs down, the upright target is theta = pi, and the angle
is wrapped to [0, 2*pi). It is the n = nx + nu = 3 case of the solver.
The double integrator is x = (p, v), pdot = v, vdot = u, stepped exactly.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.rotations import angle_normalize_2pi, rk4
from .. import resolve_device
from .base import Env, Spaces


class PendulumEnv(Env):
    def __init__(self, stabilization: bool = False, dt: float = 0.05,
                 m: float = 1.0, l: float = 1.0, g: float = 10.0,
                 max_torque: float = 2.0, max_speed: float = 8.0):
        self.nx, self.nu, self.nq = 2, 1, 1
        self.dt = dt
        self.m, self.l, self.g = m, l, g
        self.max_torque = max_torque
        self.max_speed = max_speed
        self.stabilization = stabilization
        self._max_episode_steps = 200
        self.spec_id = "Pendulum-v0" + ("-stabilize" if stabilization else "")
        self.action_space = Spaces(np.array([-max_torque]), np.array([max_torque]))
        self.Qlqr = np.array([10.0, 1.0], dtype=np.float64)
        self.Rlqr = np.array([1e-6], dtype=np.float64)
        self.targ_pos = np.array([np.pi, 0.0])

    def _xdot(self, state, u):
        # slices, not 0-dim elements (see RexQuadrotor._moments)
        th, thd = state[..., 0:1], state[..., 1:2]
        # theta measured from hanging down: thdd = -(g/l) sin(th) + u/(m l^2)
        thdd = -(self.g / self.l) * torch.sin(th) + u[..., 0:1] / (self.m * self.l**2)
        return torch.cat([thd, thdd], dim=-1)

    def dynamics(self, x, u):
        return rk4(self._xdot, x, u, self.dt)

    def state_clip(self, x):
        wrapped = angle_normalize_2pi(x[..., 0])
        return torch.stack(
            [wrapped, torch.clamp(x[..., 1], -self.max_speed, self.max_speed)],
            dim=-1)

    def reward(self, x, u):
        dth = torch.abs(x[..., 0] - math.pi)
        dth = torch.minimum(dth, 2 * math.pi - dth)
        return -(dth**2 + 0.1 * x[..., 1] ** 2 + 0.001 * torch.sum(u**2, dim=-1))

    def reset(self, generator, bsz, device="cuda", dtype=torch.float32):
        if self.stabilization:
            lo, hi = [math.pi - 0.2, -0.2], [math.pi + 0.2, 0.2]
        else:
            lo, hi = [0.0, -1.0], [2 * math.pi, 1.0]
        return self._uniform(generator, bsz, lo, hi).to(device=resolve_device(device), dtype=dtype)


class IntegratorEnv(Env):
    """Double integrator (`pendulum.py:79-101`)."""

    def __init__(self, dt: float = 0.1):
        self.nx, self.nu, self.nq = 2, 1, 1
        self.dt = dt
        self._max_episode_steps = 100
        self.spec_id = "Integrator-v0"
        self.action_space = Spaces(np.array([-1.0]), np.array([1.0]))
        self.Qlqr = np.array([1.0, 1.0], dtype=np.float64)
        self.Rlqr = np.array([1e-4], dtype=np.float64)
        self.targ_pos = np.zeros(2)

    def dynamics(self, x, u):
        p, v, a = x[..., 0:1], x[..., 1:2], u[..., 0:1]
        return torch.cat([p + self.dt * v + 0.5 * self.dt**2 * a, v + self.dt * a], dim=-1)

    def reward(self, x, u):
        return -(torch.sum(x**2, dim=-1) + 0.01 * torch.sum(u**2, dim=-1))

    def reset(self, generator, bsz, device="cuda", dtype=torch.float32):
        return self._uniform(generator, bsz, [-2.0, -2.0], [2.0, 2.0]).to(
            device=resolve_device(device), dtype=dtype)
