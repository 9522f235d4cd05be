"""ctypes bridge to the native C++ dynamics: the host-side oracle.

Port of `deqmpc_tpu/envs/native_bridge.py`. `native/src/dynamics.cpp`
steps the pendulum and the 1- and 2-link cartpoles by RK4 and gives their
Jacobians by dual numbers, batched with OpenMP. The port's compute path
never calls it: it is the oracle the torch envs' `dynamics` and
`dynamics_derivatives` are held against, on the CPU and on the card.

The library is compiled from the checkout's source at first use, with
`g++ -O3 -march=native -fPIC -fopenmp -std=c++17 -shared`, into
`deqmpc_tpu_torch/envs/_native_build/` (git-ignored), named by the
source's hash, so a changed source is compiled anew. Nothing is written
under `native/`, the committed `native/libdeqmpc_dynamics.so` is never
loaded, and a failed build raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "src", "dynamics.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native_build")
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-shared"]
PACKAGES = ("pendulum1l", "cartpole1l", "cartpole2l")

_lib: Optional[ctypes.CDLL] = None
_D = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libdeqmpc_dynamics_{digest}.so")


def build_native(force: bool = False) -> str:
    """Compile the library into BUILD_DIR unless it is there (with `force`,
    anew); processes that build at once take turns on a lock file. Returns
    the library's path; a failed build raises CalledProcessError."""
    path = _lib_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if force or not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(["g++", *CXXFLAGS, "-o", tmp, SOURCE], check=True,
                               capture_output=True, text=True)
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native())
        for env in PACKAGES:
            dyn = getattr(lib, f"{env}_dynamics")
            dyn.restype = None
            dyn.argtypes = [ctypes.c_long] + [_D] * 6
            der = getattr(lib, f"{env}_derivatives")
            der.restype = None
            der.argtypes = [ctypes.c_long] + [_D] * 10
        _lib = lib
    return _lib


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


class NativeDynamics:
    """One env's native dynamics (`package`: pendulum1l, cartpole1l or
    cartpole2l) at step `dt`. Takes numpy arrays or tensors; returns numpy
    arrays for numpy input, and for a tensor float64 tensors on its device."""

    _NQ = {"pendulum1l": 1, "cartpole1l": 2, "cartpole2l": 3}

    def __init__(self, package: str, dt: float):
        if package not in self._NQ:
            raise ValueError(f"unknown native package {package!r}; one of {PACKAGES}")
        self.package = package
        self.nq = self._NQ[package]
        self.nx = 2 * self.nq
        self.nu = 1
        self.dt = dt
        lib = _load()
        self._dyn = getattr(lib, f"{package}_dynamics")
        self._der = getattr(lib, f"{package}_derivatives")

    def _split(self, state, action):
        state = np.ascontiguousarray(_numpy(state))
        bsz = state.shape[0]
        q = np.ascontiguousarray(state[:, : self.nq])
        qd = np.ascontiguousarray(state[:, self.nq:])
        tau = np.zeros((bsz, self.nq), np.float64)
        tau[:, 0] = _numpy(action).reshape(bsz, -1)[:, 0]
        h = np.full(bsz, self.dt, np.float64)
        return bsz, q, qd, tau, h

    @staticmethod
    def _like(ref, *arrays):
        if isinstance(ref, torch.Tensor):
            return tuple(torch.as_tensor(a, device=ref.device) for a in arrays)
        return arrays

    def _step(self, state, action) -> np.ndarray:
        bsz, q, qd, tau, h = self._split(state, action)
        q_out, qd_out = np.empty_like(q), np.empty_like(qd)
        self._dyn(bsz, q, qd, tau, h, q_out, qd_out)
        return np.concatenate([q_out, qd_out], axis=-1)

    def dynamics(self, state, action):
        """The next state (bsz, nx)."""
        return self._like(state, self._step(state, action))[0]

    def dynamics_derivatives(self, state, action) -> Tuple:
        """(x', (Jx, Ju)): Jx (bsz, nx, nx), Ju (bsz, nx, nu), assembled from
        the library's six Jacobian blocks."""
        bsz, q, qd, tau, h = self._split(state, action)
        nq = self.nq
        blocks = [np.empty((bsz, nq, nq), np.float64) for _ in range(6)]
        self._der(bsz, q, qd, tau, h, *blocks)
        dq_dq, dq_dqd, dq_dtau, dqd_dq, dqd_dqd, dqd_dtau = blocks
        Jx = np.concatenate([np.concatenate([dq_dq, dq_dqd], axis=-1),
                             np.concatenate([dqd_dq, dqd_dqd], axis=-1)], axis=-2)
        Ju = np.concatenate([dq_dtau[:, :, :1], dqd_dtau[:, :, :1]], axis=-2)
        x_next, Jx, Ju = self._like(state, self._step(state, action), Jx, Ju)
        return x_next, (Jx, Ju)
