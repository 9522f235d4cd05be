"""Shared helpers of the port: attitude math, the checkpoint reader, the
state (un)normalisation of the expert data, `merge_args` and `Spaces`.

`unnormalize_states_*`, `angle_idxs_for_env` and `unwrap_angle_windows`
are the numpy paths of `deqmpc_tpu/utils/__init__.py:58-118`. The expert
trajectories store joint angles in [-pi, pi); "unnormalising" maps them
to the [0, 2pi) convention of the swing-up targets (upright = pi). A
window that crosses the 0/2pi wrap is unwrapped along time, anchored at
knot 0, so its targets are continuous.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np


@dataclasses.dataclass(init=False)
class Spaces:
    """A gym-style box (`utils/__init__.py:19-34`): float32 `low` and `high`
    broadcast to `shape`, which defaults to `low`'s shape; an unbounded
    side is None. The arrays are copies (torch takes no read-only array)."""

    low: np.ndarray
    high: np.ndarray
    shape: tuple

    def __init__(self, low=None, high=None, shape=None):
        if shape is None and low is not None:
            shape = np.shape(low)
        self.shape = tuple(shape) if shape is not None else ()
        self.low = None if low is None else self._box(low)
        self.high = None if high is None else self._box(high)

    def _box(self, v) -> np.ndarray:
        return np.array(np.broadcast_to(np.asarray(v, dtype=np.float32), self.shape))


Spaces_np = Spaces  # the reference's numpy name


def merge_args(args: argparse.Namespace, saved_args: argparse.Namespace) -> argparse.Namespace:
    """A new namespace of `args` overlaid by `saved_args`: a saved run's
    args win (`utils/__init__.py:38-47`)."""
    merged = dict(vars(args))
    merged.update(vars(saved_args))
    ns = type(args)()
    for k, v in merged.items():
        setattr(ns, k, v)
    return ns


def _shift_angles(x: np.ndarray, idxs) -> np.ndarray:
    out = np.array(x, copy=True)
    out[..., np.asarray(idxs)] = np.mod(out[..., np.asarray(idxs)], 2.0 * np.pi)
    return out


def unnormalize_states_pendulum(x):
    """Pendulum state (theta, thetadot): theta into [0, 2pi)."""
    return _shift_angles(x, np.array([0]))


def unnormalize_states_cartpole_nlink(x):
    """Cartpole n-link state (px, q1..qn-1, velocities): the joint angles."""
    nq = x.shape[-1] // 2
    return _shift_angles(x, np.arange(1, nq))


def unnormalize_states_flyingcartpole(x):
    """FlyingCartpole state: the pendulum angle (index 6)."""
    return _shift_angles(x, np.array([6]))


def angle_idxs_for_env(env_name: str, nx: int):
    """The angle dims of an env's state, or None."""
    if env_name.startswith("pendulum"):
        return np.array([0])
    if "cartpole" in env_name and "Flying" not in env_name:
        return np.arange(1, nx // 2)
    if "FlyingCartpole" in env_name:
        return np.array([6])
    return None


def unwrap_angle_windows(x: np.ndarray, idxs) -> np.ndarray:
    """np.unwrap the angle dims of a (..., T, nx) window along T."""
    if idxs is None or len(idxs) == 0:
        return x
    out = np.array(x, copy=True)
    out[..., idxs] = np.unwrap(out[..., idxs], axis=-2)
    return out
