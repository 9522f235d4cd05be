"""The port's AL solver against the JAX package in f64: the block KKT
assembly, one NewtonAL forward and a whole `ALMPC.solve`, on RexQuadrotor
problems whose first samples keep the controls inside the box and whose
last samples push them through it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.envs import RexQuadrotor as JaxQuad  # noqa: E402
from deqmpc_tpu.solvers.al_core import merit_grad_blocks as jax_merit_grad_blocks  # noqa: E402
from deqmpc_tpu.solvers.al_core import merit_function as jax_merit_function  # noqa: E402
from deqmpc_tpu.solvers.al_mpc import ALMPC as JaxALMPC  # noqa: E402
from deqmpc_tpu.solvers.newton_al import NewtonALConfig as JaxNewtonALConfig  # noqa: E402
from deqmpc_tpu.solvers.newton_al import make_newton_al  # noqa: E402
from deqmpc_tpu.solvers.types import ALState as JaxALState  # noqa: E402
from deqmpc_tpu.solvers.types import QuadCost as JaxQuadCost  # noqa: E402
from deqmpc_tpu_torch.envs import RexQuadrotor  # noqa: E402
from deqmpc_tpu_torch.solvers import (ALMPC, ALState, NewtonAL,  # noqa: E402
                                      NewtonALConfig, QuadCost)
from deqmpc_tpu_torch.solvers.al_core import merit_function, merit_grad_blocks  # noqa: E402

torch.set_num_threads(2)

T, BSZ = 5, 4
ARGS = ("xu", "x0", "lam", "rho", "Q", "q")
ACTIVE = 2  # samples with the control box inactive
TOL = dict(rtol=1e-8, atol=1e-8)


def _problem(seed=0):
    env = RexQuadrotor()
    nx, nu = env.nx, env.nu
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.normal(size=(BSZ, T, nx))
    # samples [0, ACTIVE) inside the box [11.5, 18.3], the rest pushed
    # through both of its faces
    spread = np.where(np.arange(BSZ) < ACTIVE, 1.0, 4.5)[:, None, None]
    u = env.u_hover + spread * rng.uniform(-1, 1, size=(BSZ, T, nu))
    xu = np.concatenate([x, u], axis=-1)
    xu_ref = xu + 0.2 * rng.normal(size=xu.shape)
    # the env's state weights, and a control weight that keeps the Newton
    # steps in range (the env's own is 1e-8)
    Q = np.broadcast_to(np.concatenate([env.Qlqr, np.full(nu, 0.1)]), xu.shape).copy()
    q = -Q * xu_ref
    x0 = x[:, 0] + 0.1 * rng.normal(size=(BSZ, nx))
    ncon = T * nx + 2 * nu * T
    lam = 0.1 * rng.normal(size=(BSZ, ncon))
    lam[:, T * nx:] = np.abs(lam[:, T * nx:])
    lam[:ACTIVE, T * nx:] = 0.0
    rho = np.full((BSZ, 1), 10.0)
    return env, dict(xu=xu, Q=Q, q=q, x0=x0, lam=lam, rho=rho)


def _jax_fns(jenv):
    def dyn_jac(x, u):
        xn, (Jx, Ju) = jenv.dynamics_derivatives(x, u)
        return xn, jnp.concatenate([Jx, Ju], axis=-1)

    return jenv.dynamics, dyn_jac


def _torch_fns(env):
    def dyn_jac(x, u):
        xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
        return xn, torch.cat([Jx, Ju], dim=-1)

    return env.dynamics, dyn_jac


def _box(env, lib):
    lo, hi = env.action_space.low.astype(np.float64), env.action_space.high.astype(np.float64)
    return (jnp.asarray(lo), jnp.asarray(hi)) if lib == "jax" else (
        torch.as_tensor(lo), torch.as_tensor(hi))


def test_merit_grad_blocks_match_jax():
    env, p = _problem()
    jenv = JaxQuad()
    nx = env.nx
    J = {k: jnp.asarray(v) for k, v in p.items()}
    Tt = {k: torch.as_tensor(v) for k, v in p.items()}
    jdyn, jdyn_jac = _jax_fns(jenv)

    @jax.jit
    def reference(J):
        xn, F = jdyn_jac(J["xu"][:, :-1, :nx], J["xu"][:, :-1, nx:])
        r_eq = jnp.concatenate([J["xu"][:, 1:, :nx] - xn,
                                (J["xu"][:, 0, :nx] - J["x0"])[:, None]], 1)
        blocks = jax_merit_grad_blocks(J["xu"], J["Q"], J["q"], J["x0"], J["lam"], J["rho"],
                                       F, *_box(env, "jax"), dyn_eq_res=r_eq)
        merit = jax_merit_function(jdyn, J["xu"], J["Q"], J["q"], J["x0"], J["lam"],
                                   J["rho"], *_box(env, "jax"))
        return blocks, merit

    ref, m_ref = reference(J)
    tdyn, tdyn_jac = _torch_fns(env)
    with torch.inference_mode():
        xn_t, F_t = tdyn_jac(Tt["xu"][:, :-1, :nx], Tt["xu"][:, :-1, nx:])
        r_eq_t = torch.cat([Tt["xu"][:, 1:, :nx] - xn_t,
                            (Tt["xu"][:, 0, :nx] - Tt["x0"])[:, None]], 1)
        out = merit_grad_blocks(Tt["xu"], Tt["Q"], Tt["q"], Tt["x0"], Tt["lam"], Tt["rho"],
                                F_t, *_box(env, "torch"), dyn_eq_res=r_eq_t)
    active = (np.asarray(ref[4])[:, T * nx:] > 0).any(axis=1)
    np.testing.assert_array_equal(active, np.arange(BSZ) >= ACTIVE)
    for name, a, b in zip(("g", "D", "O", "res", "res_c"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)
    m = merit_function(tdyn, Tt["xu"], Tt["Q"], Tt["q"], Tt["x0"], Tt["lam"], Tt["rho"],
                       *_box(env, "torch"))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), **TOL)


def test_newton_al_forward_matches_jax():
    env, p = _problem(seed=1)
    jenv = JaxQuad()
    newton_j = make_newton_al(JaxNewtonALConfig(nx=env.nx, nu=env.nu, T=T, tridiag_backend="xla"),
                              *_jax_fns(jenv), *_box(env, "jax"))
    xu_ref, status_ref = newton_j(*(jnp.asarray(p[k]) for k in ARGS))
    newton_t = NewtonAL(NewtonALConfig(nx=env.nx, nu=env.nu, T=T), *_torch_fns(env),
                        *_box(env, "torch"))
    with torch.inference_mode():
        xu, status = newton_t(*(torch.as_tensor(p[k]) for k in ARGS))
    assert 1 <= newton_t.steps <= 4
    np.testing.assert_array_equal(status.numpy(), np.asarray(status_ref))
    np.testing.assert_allclose(xu.numpy(), np.asarray(xu_ref), **TOL)
    # every sample moved
    assert (np.abs(xu.numpy() - p["xu"]).max(axis=(1, 2)) > 1e-3).all()


def test_almpc_solve_matches_jax():
    env, p = _problem(seed=2)
    jenv = JaxQuad()
    nx, nu = env.nx, env.nu
    lo, hi = env.action_space.low, env.action_space.high
    x_init, u_init = p["xu"][..., :nx], p["xu"][..., nx:]
    ctrl_j = JaxALMPC(nx, nu, T, lo, hi, *_jax_fns(jenv), al_iter=2, rho_max=1e5,
                      dtype=jnp.float64, tridiag_backend="xla")
    xj, uj, sj, state_j = ctrl_j.solve(
        jnp.asarray(p["x0"]), JaxQuadCost(jnp.asarray(p["Q"]), jnp.asarray(p["q"]), None),
        JaxALState.init(BSZ, T, nx, nu, ctrl_j.ncon, jnp.float64),
        x_init=jnp.asarray(x_init), u_init=jnp.asarray(u_init))
    ctrl_t = ALMPC(nx, nu, T, lo, hi, *_torch_fns(env), al_iter=2, rho_max=1e5,
                   dtype=torch.float64, device="cpu")
    assert ctrl_t.ncon == ctrl_j.ncon
    with torch.inference_mode():
        x, u, s, state = ctrl_t.solve(
            torch.as_tensor(p["x0"]),
            QuadCost(torch.as_tensor(p["Q"]), torch.as_tensor(p["q"]), None),
            ctrl_t.init_state(BSZ), torch.as_tensor(x_init), torch.as_tensor(u_init))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), **TOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_allclose(state.lam.numpy(), np.asarray(state_j.lam), **TOL)
    np.testing.assert_allclose(state.rho.numpy(), np.asarray(state_j.rho), rtol=0, atol=0)
    assert isinstance(state, ALState) and bool(state.has_init.all())
