"""The port's obstacle rows against the JAX package in f64: the residuals,
merit and block KKT assembly with active sphere rows, the nearest-k
selection (same centers, same order), whole `ALMPC.solve` calls with
obstacles (the triple integrator of `tests/test_obstacles.py` and the
flying cartpole), and the NewtonAL Function's implicit backward against
the `custom_vjp` with active rows, which a backward that drops the rows
fails. Tolerance 1e-8: rounding through at most 8 Newton steps, as in
`tests/test_torch_al.py`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.envs import FlyingCartpole as JaxFlying  # noqa: E402
from deqmpc_tpu.solvers import ObstacleSet as JaxObstacleSet  # noqa: E402
from deqmpc_tpu.solvers.al_core import lin_dyn_fns  # noqa: E402
from deqmpc_tpu.solvers.al_core import merit_function as jax_merit_function  # noqa: E402
from deqmpc_tpu.solvers.al_core import merit_grad_blocks as jax_merit_grad_blocks  # noqa: E402
from deqmpc_tpu.solvers.al_core import num_constraints as jax_num_constraints  # noqa: E402
from deqmpc_tpu.solvers.al_core import obstacle_residuals as jax_obstacle_residuals  # noqa: E402
from deqmpc_tpu.solvers.al_mpc import ALMPC as JaxALMPC  # noqa: E402
from deqmpc_tpu.solvers.newton_al import NewtonALConfig as JaxNewtonALConfig  # noqa: E402
from deqmpc_tpu.solvers.newton_al import make_newton_al  # noqa: E402
from deqmpc_tpu.solvers.types import ALState as JaxALState  # noqa: E402
from deqmpc_tpu.solvers.types import LinDx as JaxLinDx  # noqa: E402
from deqmpc_tpu.solvers.types import QuadCost as JaxQuadCost  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.solvers import (ALMPC, LinDx, NewtonAL, NewtonALConfig,  # noqa: E402
                                      ObstacleSet, QuadCost, newton_al)
from deqmpc_tpu_torch.solvers.al_core import (merit_function, merit_grad_blocks,  # noqa: E402
                                              num_constraints, obstacle_residuals)

torch.set_num_threads(2)

TOL = dict(rtol=1e-8, atol=1e-8)
T, BSZ, N_SEL, RADIUS = 5, 4, 4, 0.5
ARGS = ("xu", "x0", "lam", "rho", "Q", "q")


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), **tol, err_msg=msg)


def _fns(env, lib):
    if lib == "jax":
        def dyn_jac(x, u):
            xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
            return xn, jnp.concatenate([Jx, Ju], axis=-1)
    else:
        def dyn_jac(x, u):
            xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
            return xn, torch.cat([Jx, Ju], dim=-1)
    return env.dynamics, dyn_jac


def _box(env, lib):
    lo, hi = env.action_space.low.astype(np.float64), env.action_space.high.astype(np.float64)
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    return conv(lo), conv(hi)


def _flying_problem(seed=0, rho=10.0):
    """A flying-cartpole Newton problem in f64 whose selected spheres sit
    within 0.3 of the knots (radius 0.5): most obstacle rows are active, a
    few are not."""
    env = make_env("flyingcartpole")
    nx, nu = env.nx, env.nu
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.normal(size=(BSZ, T, nx))
    x[..., 6] += np.pi
    u = 0.5 * env.action_space.high * rng.uniform(-1, 1, size=(BSZ, T, nu))
    xu = np.concatenate([x, u], axis=-1)
    centers = x[..., None, :3] + 0.3 * rng.normal(size=(BSZ, T, N_SEL, 3))
    Q = np.broadcast_to(np.concatenate([env.Qlqr, np.full(nu, 0.1)]), xu.shape).copy()
    q = -Q * (xu + 0.2 * rng.normal(size=xu.shape))
    x0 = x[:, 0] + 0.1 * rng.normal(size=(BSZ, nx))
    ncon = num_constraints(T, nx, nu, N_SEL)
    lam = 0.1 * rng.normal(size=(BSZ, ncon))
    lam[:, T * nx:] = np.abs(lam[:, T * nx:])
    return env, dict(xu=xu, x0=x0, lam=lam, rho=np.full((BSZ, 1), rho), Q=Q, q=q), centers


def test_num_constraints_match_jax():
    for n_sel in (0, 4):
        assert num_constraints(5, 14, 4, n_sel) == jax_num_constraints(5, 14, 4, n_obs_sel=n_sel)


def test_residuals_merit_and_blocks_match_jax_with_active_rows():
    env, p, centers = _flying_problem()
    jenv = JaxFlying()
    nx = env.nx
    J = {k: jnp.asarray(v) for k, v in p.items()}
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    jobs = JaxObstacleSet(jnp.asarray(centers), RADIUS)
    tobs = ObstacleSet(torch.as_tensor(centers), RADIUS)
    r_ref, rc_ref = jax_obstacle_residuals(J["xu"][..., :nx], jobs)
    r, rc = obstacle_residuals(t["xu"][..., :nx], tobs)
    _close(r, r_ref, msg="res")
    _close(rc, rc_ref, msg="res_clamp")
    active = _np(r) >= 0
    assert 0.2 < active.mean() < 0.95, active.mean()  # active and inactive rows

    jdyn, jdyn_jac = _fns(jenv, "jax")

    @jax.jit
    def reference(J):
        xn, F = jdyn_jac(J["xu"][:, :-1, :nx], J["xu"][:, :-1, nx:])
        r_eq = jnp.concatenate([J["xu"][:, 1:, :nx] - xn,
                                (J["xu"][:, 0, :nx] - J["x0"])[:, None]], 1)
        blocks = jax_merit_grad_blocks(J["xu"], J["Q"], J["q"], J["x0"], J["lam"], J["rho"], F,
                                       *_box(env, "jax"), obs=jobs, dyn_eq_res=r_eq)
        merit = jax_merit_function(jdyn, J["xu"], J["Q"], J["q"], J["x0"], J["lam"], J["rho"],
                                   *_box(env, "jax"), obs=jobs)
        return blocks, merit

    ref, m_ref = reference(J)
    tdyn, tdyn_jac = _fns(env, "torch")
    with torch.inference_mode():
        xn, F = tdyn_jac(t["xu"][:, :-1, :nx], t["xu"][:, :-1, nx:])
        r_eq = torch.cat([t["xu"][:, 1:, :nx] - xn, (t["xu"][:, 0, :nx] - t["x0"])[:, None]], 1)
        out = merit_grad_blocks(t["xu"], t["Q"], t["q"], t["x0"], t["lam"], t["rho"], F,
                                *_box(env, "torch"), dyn_eq_res=r_eq, obs=tobs)
        m = merit_function(tdyn, t["xu"], t["Q"], t["q"], t["x0"], t["lam"], t["rho"],
                           *_box(env, "torch"), tobs)
    for name, a, b in zip(("g", "D", "O", "res", "res_c"), out, ref):
        _close(a, b, msg=name)
    _close(m, m_ref, msg="merit")
    # the rows reach the blocks: without them, D's xyz 3x3 and g change
    with torch.inference_mode():
        bare = merit_grad_blocks(t["xu"], t["Q"], t["q"], t["x0"], t["lam"], t["rho"], F,
                                 *_box(env, "torch"), dyn_eq_res=r_eq)
    assert np.abs(_np(out[1] - bare[1])[..., :3, :3]).max() > 1.0
    assert np.abs(_np(out[1] - bare[1])[..., 3:, :]).max() == 0.0
    assert out[3].shape[1] == bare[3].shape[1] + T * N_SEL


@pytest.mark.parametrize("n_sel", [1, 4])
def test_select_obstacles_matches_jax_centers_and_order(n_sel):
    env = make_env("flyingcartpole_obstacles")
    field = env.obstacle_positions
    rng = np.random.default_rng(n_sel)
    x_ref = np.concatenate([rng.uniform(-5, 5, size=(6, T, 3)),
                            rng.normal(size=(6, T, env.nx - 3))], axis=-1)
    kw = dict(dyn=None, dyn_jac=None, n_obs_sel=n_sel)
    jctrl = JaxALMPC(env.nx, env.nu, T, env.action_space.low, env.action_space.high,
                     obstacles=JaxObstacleSet(jnp.asarray(field), env.obstacle_radius),
                     dtype=jnp.float64, **kw)
    ref = jctrl.select_obstacles(jnp.asarray(x_ref))
    ctrl = ALMPC(env.nx, env.nu, T, env.action_space.low, env.action_space.high,
                 obstacles=ObstacleSet(torch.as_tensor(field), env.obstacle_radius),
                 dtype=torch.float64, device="cpu", **kw)
    got = ctrl.select_obstacles(torch.as_tensor(x_ref))
    assert got.centers.shape == (6, T, n_sel, 3) and got.radius == ref.radius
    np.testing.assert_array_equal(_np(got.centers), np.asarray(ref.centers))
    # nearest first
    d = np.linalg.norm(_np(got.centers) - x_ref[..., None, :3], axis=-1)
    assert (np.diff(d, axis=-1) >= 0).all()
    assert ctrl.ncon == jctrl.ncon == num_constraints(T, env.nx, env.nu, n_sel)


def test_solve_requires_the_selected_obstacles():
    env = make_env("flyingcartpole_obstacles")
    ctrl = ALMPC(env.nx, env.nu, T, env.action_space.low, env.action_space.high,
                 *_fns(env, "torch"),
                 obstacles=ObstacleSet(torch.as_tensor(env.obstacle_positions), 0.25),
                 dtype=torch.float64, device="cpu")
    x0 = torch.zeros((2, env.nx), dtype=torch.float64)
    Q = torch.ones((2, T, env.nx + env.nu), dtype=torch.float64)
    with pytest.raises(ValueError, match="select_obstacles"):
        ctrl.solve(x0, QuadCost(Q, Q, None), ctrl.init_state(2))


def _triple_integrator(bsz, T_, lib, dt=0.2):
    """`tests/test_obstacles.py`'s 3-D single integrator: x (pos 3), u (vel 3)."""
    F = np.tile(np.concatenate([np.eye(3), dt * np.eye(3)], axis=1)[None, None],
                (bsz, T_ - 1, 1, 1))
    f = np.zeros((bsz, T_ - 1, 3))
    if lib == "jax":
        return lin_dyn_fns(JaxLinDx(F=jnp.asarray(F), f=jnp.asarray(f)))
    return ALMPC.linear_dynamics(LinDx(F=torch.as_tensor(F), f=torch.as_tensor(f)))


def test_almpc_solve_with_obstacles_on_the_triple_integrator_matches_jax():
    bsz, T_, nx, nu, radius = 2, 8, 3, 3, 0.3
    x0 = np.tile([-1.0, 0.0, 0.0], (bsz, 1))
    x0[1] += [0.0, 0.05, -0.02]
    goal = np.array([1.0, 0.0, 0.0])
    Q = np.tile([1.0] * nx + [0.1] * nu, (bsz, T_, 1))
    q = -Q * np.tile(np.concatenate([goal, np.zeros(nu)]), (bsz, T_, 1))
    field = np.zeros((40, 3))
    field[1:] = np.random.default_rng(0).uniform(5, 10, (39, 3))
    x_ref = np.broadcast_to(goal, (bsz, T_, nx)).copy()
    box = (-5 * np.ones(nu), 5 * np.ones(nu))

    jctrl = JaxALMPC(nx, nu, T_, *box, *_triple_integrator(bsz, T_, "jax"), dtype=jnp.float64,
                     obstacles=JaxObstacleSet(jnp.asarray(field), radius), n_obs_sel=4,
                     tridiag_backend="xla")
    jsel = jctrl.select_obstacles(jnp.asarray(x_ref))
    xj, uj, _, sj = jctrl.solve(jnp.asarray(x0), JaxQuadCost(jnp.asarray(Q), jnp.asarray(q),
                                                             None),
                                jctrl.init_state(bsz), al_iter=8, obstacles=jsel)
    ctrl = ALMPC(nx, nu, T_, *box, *_triple_integrator(bsz, T_, "torch"), dtype=torch.float64,
                 obstacles=ObstacleSet(torch.as_tensor(field), radius), n_obs_sel=4,
                 device="cpu")
    with torch.inference_mode():
        sel = ctrl.select_obstacles(torch.as_tensor(x_ref))
        x, u, _, st = ctrl.solve(torch.as_tensor(x0), QuadCost(torch.as_tensor(Q),
                                                               torch.as_tensor(q), None),
                                 ctrl.init_state(bsz), al_iter=8, obstacles=sel)
    _close(x, xj, msg="x")
    _close(u, uj, msg="u")
    # the duals, to 1e-8 of the largest rho (the dual step multiplies the
    # residual's rounding by rho)
    _close(st.lam, sj.lam, dict(rtol=1e-8, atol=1e-8 * float(np.max(sj.rho))), msg="lam")
    _close(st.rho, sj.rho, msg="rho")
    # the trajectory went round the sphere at the origin
    assert np.linalg.norm(_np(x), axis=-1).min() > radius - 0.02


def _flying_solve_case():
    env = make_env("flyingcartpole_obstacles")
    jenv = JaxFlying(obstacles=True)
    rng = np.random.default_rng(3)
    field = env.obstacle_positions
    nx, nu = env.nx, env.nu
    # references that pass through spheres of the field
    x_ref = 0.2 * rng.normal(size=(BSZ, T, nx))
    x_ref[..., 6] += np.pi
    x_ref[..., :3] += field[rng.integers(0, len(field), size=BSZ)][:, None] + np.linspace(
        -0.4, 0.4, T)[None, :, None]
    x0 = x_ref[:, 0] + 0.05 * rng.normal(size=(BSZ, nx))
    Q = np.broadcast_to(np.concatenate([env.Qlqr, np.full(nu, 0.1)]), (BSZ, T, nx + nu)).copy()
    xu_ref = np.concatenate([x_ref, np.zeros((BSZ, T, nu))], axis=-1)
    return env, jenv, field, dict(x0=x0, Q=Q, q=-Q * xu_ref, x_ref=x_ref)


def test_almpc_solve_with_obstacles_on_the_flying_cartpole_matches_jax():
    env, jenv, field, p = _flying_solve_case()
    nx, nu = env.nx, env.nu
    lo, hi = env.action_space.low, env.action_space.high
    u_init = np.zeros((BSZ, T, nu))
    jctrl = JaxALMPC(nx, nu, T, lo, hi, *_fns(jenv, "jax"), al_iter=2, rho_max=1e5,
                     obstacles=JaxObstacleSet(jnp.asarray(field), env.obstacle_radius),
                     dtype=jnp.float64, tridiag_backend="xla")
    jsel = jctrl.select_obstacles(jnp.asarray(p["x_ref"]))
    jctrl._newton = jax.jit(jctrl._newton)  # the selection is fixed for this solve
    xj, uj, _, sj = jctrl.solve(jnp.asarray(p["x0"]), JaxQuadCost(jnp.asarray(p["Q"]),
                                                                  jnp.asarray(p["q"]), None),
                                JaxALState.init(BSZ, T, nx, nu, jctrl.ncon, jnp.float64),
                                x_init=jnp.asarray(p["x_ref"]), u_init=jnp.asarray(u_init),
                                obstacles=jsel)
    ctrl = ALMPC(nx, nu, T, lo, hi, *_fns(env, "torch"), al_iter=2, rho_max=1e5,
                 obstacles=ObstacleSet(torch.as_tensor(field), env.obstacle_radius),
                 dtype=torch.float64, device="cpu")
    with torch.inference_mode():
        sel = ctrl.select_obstacles(torch.as_tensor(p["x_ref"]))
        x, u, _, st = ctrl.solve(torch.as_tensor(p["x0"]),
                                 QuadCost(torch.as_tensor(p["Q"]), torch.as_tensor(p["q"]), None),
                                 ctrl.init_state(BSZ), torch.as_tensor(p["x_ref"]),
                                 torch.as_tensor(u_init), obstacles=sel)
    _close(x, xj, msg="x")
    _close(u, uj, msg="u")
    _close(st.lam, sj.lam, dict(rtol=1e-8, atol=1e-8 * float(np.max(sj.rho))), msg="lam")
    _close(st.rho, sj.rho, msg="rho")
    # obstacle rows were active during the solve: their duals moved
    off = T * nx + 2 * nu * T
    assert np.abs(_np(st.lam)[:, off:]).max() > 1e-3


# -- the NewtonAL Function against the custom_vjp, obstacle rows active ----------

def _jax_vjp(p, centers, g):
    jenv = JaxFlying()
    obs = JaxObstacleSet(jnp.asarray(centers), RADIUS)
    newton = make_newton_al(JaxNewtonALConfig(nx=jenv.nx, nu=jenv.nu, T=T,
                                              tridiag_backend="xla"),
                            *_fns(jenv, "jax"), *_box(jenv, "jax"), obs_getter=lambda: obs)
    J = {k: jnp.asarray(v) for k, v in p.items()}
    out, vjp = jax.vjp(jax.jit(lambda Q, q: newton(J["xu"], J["x0"], J["lam"], J["rho"],
                                                   Q, q)[0]), J["Q"], J["q"])
    return (np.asarray(out), *map(np.asarray, vjp(jnp.asarray(g))))


def _port_vjp(env, p, centers, g):
    newton = NewtonAL(NewtonALConfig(nx=env.nx, nu=env.nu, T=T), *_fns(env, "torch"),
                      *_box(env, "torch"))
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    Q, q = t["Q"].requires_grad_(), t["q"].requires_grad_()
    obs = ObstacleSet(torch.as_tensor(centers), RADIUS)
    out, _ = newton(t["xu"], t["x0"], t["lam"], t["rho"], Q, q, obs)
    out.backward(torch.as_tensor(g))
    assert newton.backward_solves == 1
    return _np(out), _np(Q.grad), _np(q.grad), obs


@pytest.fixture(scope="module")
def function_case():
    env, p, centers = _flying_problem(seed=5)
    g = np.random.default_rng(8).normal(size=p["xu"].shape)
    return env, p, centers, g, _jax_vjp(p, centers, g)


def _check_function(case):
    env, p, centers, g, (out_ref, dQ_ref, dq_ref) = case
    out, dQ, dq, obs = _port_vjp(env, p, centers, g)
    _close(out, out_ref, msg="xu_out")
    _close(dQ, dQ_ref, msg="dQ")
    _close(dq, dq_ref, msg="dq")
    return out, dq, obs


def test_newton_function_with_active_obstacle_rows_matches_custom_vjp(function_case):
    out, dq, obs = _check_function(function_case)
    # the rows are active at the solution, where the backward assembles D
    r, _ = obstacle_residuals(torch.as_tensor(out[..., :14]), obs)
    assert (_np(r) >= 0).mean() > 0.2
    assert np.abs(dq).max() > 1e-3


def test_a_backward_without_the_obstacle_rows_fails_the_check(function_case, monkeypatch):
    Function = newton_al._NewtonALFunction
    good = Function.forward

    def without_rows(ctx, newton, xu, x0, lam, rho, Q, q, obs):
        out = good(ctx, newton, xu, x0, lam, rho, Q, q, obs)
        _, D, O, _, _ = newton._assemble(out[0], Q, q, x0, lam, rho, None)
        ctx.save_for_backward(D, O, out[0])
        return out

    monkeypatch.setattr(Function, "forward", staticmethod(without_rows))
    with pytest.raises(AssertionError, match="dQ|dq"):
        _check_function(function_case)
