"""The native C++ dynamics through the port's bridge
(`deqmpc_tpu_torch/envs/native_bridge.py`) as the oracle of the port's torch
envs, and against JAX's bridge.

The port compiles `native/src/dynamics.cpp` into its own git-ignored
directory at first use; JAX's bridge loads the committed library. Held at
`tests/test_native.py`'s tolerances: the next state within rtol 1e-9 atol
1e-10 of the torch env's `dynamics`, the dual-number Jacobians within
rtol 1e-8 atol 1e-9 of its `vmap(jacfwd)` ones; the two bridges (one
source, two builds) within rtol 1e-12 atol 1e-14.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deqmpc_tpu.envs.native_bridge import NativeDynamics as JaxNativeDynamics  # noqa: E402
from deqmpc_tpu_torch.envs import CartpoleEnv, PendulumEnv  # noqa: E402
from deqmpc_tpu_torch.envs import native_bridge  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"pendulum1l": lambda: PendulumEnv(dt=0.05),
         "cartpole1l": lambda: CartpoleEnv(nx=4, dt=0.05),
         "cartpole2l": lambda: CartpoleEnv(nx=6, dt=0.03)}
DYN_TOL = dict(rtol=1e-9, atol=1e-10)
JAC_TOL = dict(rtol=1e-8, atol=1e-9)
BRIDGE_TOL = dict(rtol=1e-12, atol=1e-14)


def _inputs(env, seed, bsz, scale):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(bsz, env.nx)) * scale, rng.normal(size=(bsz, env.nu)) * scale


def test_the_library_is_built_in_the_ports_directory():
    path = native_bridge.build_native()
    assert os.path.dirname(path) == native_bridge.BUILD_DIR and os.path.exists(path)
    assert not path.startswith(os.path.join(REPO, "native") + os.sep)
    assert native_bridge.build_native() == path  # built once


@pytest.mark.parametrize("package", sorted(CASES))
def test_native_matches_the_port_dynamics(package):
    env = CASES[package]()
    nat = native_bridge.NativeDynamics(package, dt=env.dt)
    x, u = _inputs(env, 0, 16, 0.5)
    got = nat.dynamics(x, u)  # numpy in, numpy out
    assert isinstance(got, np.ndarray)
    ref = env.dynamics(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, ref, **DYN_TOL)


@pytest.mark.parametrize("package", sorted(CASES))
def test_native_jacobians_match_the_port(package):
    env = CASES[package]()
    nat = native_bridge.NativeDynamics(package, dt=env.dt)
    x, u = (torch.as_tensor(a) for a in _inputs(env, 1, 8, 0.4))
    x_next, (Jx, Ju) = nat.dynamics_derivatives(x, u)  # tensors in, tensors out
    assert all(isinstance(t, torch.Tensor) for t in (x_next, Jx, Ju))
    ref_next, (Jx_ref, Ju_ref) = env.dynamics_derivatives(x, u)
    torch.testing.assert_close(x_next, ref_next, **DYN_TOL)
    torch.testing.assert_close(Jx, Jx_ref, **JAC_TOL)
    torch.testing.assert_close(Ju, Ju_ref, **JAC_TOL)


@pytest.mark.parametrize("package", sorted(CASES))
def test_port_bridge_matches_jax_bridge(package):
    env = CASES[package]()
    x, u = _inputs(env, 2, 32, 0.5)
    ours = native_bridge.NativeDynamics(package, dt=env.dt)
    theirs = JaxNativeDynamics(package, dt=env.dt)
    np.testing.assert_allclose(ours.dynamics(x, u), theirs.dynamics(x, u), **BRIDGE_TOL)
    _, (Jx, Ju) = ours.dynamics_derivatives(x, u)
    _, (Jx_j, Ju_j) = theirs.dynamics_derivatives(x, u)
    np.testing.assert_allclose(Jx, Jx_j, **BRIDGE_TOL)
    np.testing.assert_allclose(Ju, Ju_j, **BRIDGE_TOL)


def test_unknown_package_is_refused():
    with pytest.raises(ValueError, match="unknown native package"):
        native_bridge.NativeDynamics("quadrotor", dt=0.05)
