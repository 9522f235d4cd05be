"""Quaternion / Modified-Rodrigues-Parameter (MRP) attitude math on tensors.

Port of `deqmpc_tpu/utils/rotations.py`: the dynamics' attitude math,
and the rest of that module (`mrp2rot` for the flying cartpole's cascade
teacher, the quaternion product and conjugate, the angle helpers).
Conventions are the same:
quaternions are scalar-first `(w, x, y, z)`, MRP `p = q_vec / (1 + q_w)`.
Every function broadcasts over leading dims and works under
`torch.func.vmap` / `jacfwd` (no data-dependent Python control flow).
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "deg2rad",
    "quat_multiply",
    "quat_conj",
    "angle_normalize_2pi",
    "angle_normalize",
    "quat2mrp",
    "mrp2quat",
    "mrp2rot",
    "quatrot",
    "w2pdotkinematics_mrp",
    "euler_to_quaternion",
    "rk4",
]


def deg2rad(d):
    return d * math.pi / 180.0


def angle_normalize_2pi(x):
    """Wrap angles into [0, 2*pi)."""
    return torch.remainder(x, 2.0 * math.pi)


def angle_normalize(x):
    """Wrap angles into [-pi, pi)."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def quat_multiply(q1, q2):
    """Hamilton product, scalar-first, broadcasting over leading dims."""
    w1, x1, y1, z1 = torch.movedim(q1, -1, 0)
    w2, x2, y2, z2 = torch.movedim(q2, -1, 0)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat2mrp(q):
    """Unit quaternion (scalar-first) -> MRP: p = q_vec / (1 + q_w)."""
    return q[..., 1:] / (1.0 + q[..., :1])


def mrp2quat(p):
    """MRP -> unit quaternion: q_w = (1 - |p|^2) / (1 + |p|^2),
    q_vec = 2 p / (1 + |p|^2)."""
    n2 = torch.sum(p * p, dim=-1, keepdim=True)
    denom = 1.0 + n2
    return torch.cat([(1.0 - n2) / denom, 2.0 * p / denom], dim=-1)


def mrp2rot(p):
    """MRP -> rotation matrix (..., 3, 3):
    R = I + (8 [p]_x^2 + 4 (1 - |p|^2) [p]_x) / (1 + |p|^2)^2."""
    n2 = torch.sum(p * p, dim=-1)[..., None, None]
    px = _skew(p)
    pxpx = px @ px
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(pxpx.shape)
    return eye + (8.0 * pxpx + 4.0 * (1.0 - n2) * px) / (1.0 + n2) ** 2


def _skew(v):
    """The cross-product matrix [v]_x (..., 3, 3)."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def quatrot(q, v):
    """Rotate vector v by unit quaternion q (vector part of q (0,v) q^-1)."""
    qv = q[..., 1:]
    qw = q[..., :1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def w2pdotkinematics_mrp(p, w):
    """MRP kinematics: pdot = 0.25 ((1 - |p|^2) w + 2 p x w + 2 (p.w) p)."""
    n2 = torch.sum(p * p, dim=-1, keepdim=True)
    pw = torch.sum(p * w, dim=-1, keepdim=True)
    return 0.25 * ((1.0 - n2) * w + 2.0 * torch.linalg.cross(p, w, dim=-1)
                   + 2.0 * pw * p)


def euler_to_quaternion(e):
    """ZYX (roll, pitch, yaw) in (..., 3) -> scalar-first quaternion."""
    roll, pitch, yaw = e[..., 0], e[..., 1], e[..., 2]
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def rk4(f, x, u, dt):
    """Classic RK4 step for xdot = f(x, u)."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
