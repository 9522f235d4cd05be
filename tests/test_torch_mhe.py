"""The state-estimator (MHE) flavour of the AL solver and the TrackingMPC
options of the policy variants, the port against the JAX package in f64:
the SE residuals, merit and block assembly (no initial-state row, no
control box, no S'S on block 0), NewtonAL with `state_estimator=True` and
its implicit backward against the `custom_vjp` (the estimator's own cost,
whose last block is singular on the controls, and one with a control
weight, whose systems are positive definite), and `TrackingMPC` with
q-scaling and in estimator mode, forward and gradients.

Tolerance 1e-8, as the tracking solver's parity (`test_torch_al.py`): a few
Newton steps and one solve of rounding."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.envs import PendulumEnv as JaxPendulum  # noqa: E402
from deqmpc_tpu.policies.tracking_mpc import TrackingMPC as JaxTrackingMPC  # noqa: E402
from deqmpc_tpu.solvers import al_core as jax_al_core  # noqa: E402
from deqmpc_tpu.solvers.newton_al import NewtonALConfig as JaxNewtonALConfig  # noqa: E402
from deqmpc_tpu.solvers.newton_al import make_newton_al  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.policies import TrackingMPC  # noqa: E402
from deqmpc_tpu_torch.solvers import NewtonAL, NewtonALConfig, al_core, newton_al  # noqa: E402

torch.set_num_threads(2)

H, BSZ = 3, 4
ARGS = ("xu", "x0", "lam", "rho", "Q", "q")
TOL = dict(rtol=1e-8, atol=1e-8)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _problem(seed, u_weight=0.0):
    """An MHE problem on the pendulum: a noisy state history with its
    actions, the estimator's cost (states only, or with `u_weight` on the
    controls), duals on the eq rows (the zero row's too, which must not
    act) and rho 10."""
    env = make_env("pendulum")
    nx, nu = env.nx, env.nu
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.normal(size=(BSZ, H, nx))
    u = rng.normal(size=(BSZ, H, nu))
    xu = np.concatenate([x, u], axis=-1)
    Q = np.broadcast_to(np.concatenate([env.Qlqr, np.full(nu, u_weight)]), xu.shape).copy()
    q = -Q * (xu + 0.2 * rng.normal(size=xu.shape))
    x0 = x[:, 0] + 0.1 * rng.normal(size=(BSZ, nx))
    lam = 0.1 * rng.normal(size=(BSZ, H * nx))
    rho = np.full((BSZ, 1), 10.0)
    return env, dict(xu=xu, x0=x0, lam=lam, rho=rho, Q=Q, q=q)


def _jax_fns():
    jenv = JaxPendulum()

    def dyn_jac(x, u):
        xn, (Jx, Ju) = jenv.dynamics_derivatives(x, u)
        return xn, jnp.concatenate([Jx, Ju], axis=-1)

    return jenv.dynamics, dyn_jac


def _torch_fns(env):
    def dyn_jac(x, u):
        xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
        return xn, torch.cat([Jx, Ju], dim=-1)

    return env.dynamics, dyn_jac


def test_se_residuals_merit_and_blocks_match_jax():
    env, p = _problem(0, u_weight=0.1)
    nx = env.nx
    jdyn, jdyn_jac = _jax_fns()
    J = {k: jnp.asarray(v) for k, v in p.items()}
    Tt = {k: torch.as_tensor(v) for k, v in p.items()}

    @jax.jit
    def reference(J):
        x, u = J["xu"][..., :nx], J["xu"][..., nx:]
        r_eq = jax_al_core.eq_residuals_se(jdyn, x, u, J["x0"])
        _, F = jdyn_jac(x[:, :-1], u[:, :-1])
        blocks = jax_al_core.merit_grad_blocks(J["xu"], J["Q"], J["q"], J["x0"], J["lam"],
                                               J["rho"], F, None, None, state_estimator=True,
                                               dyn_eq_res=r_eq)
        merit = jax_al_core.merit_function(jdyn, J["xu"], J["Q"], J["q"], J["x0"], J["lam"],
                                           J["rho"], None, None, state_estimator=True)
        return r_eq, blocks, merit

    r_ref, blocks_ref, m_ref = reference(J)
    tdyn, tdyn_jac = _torch_fns(env)
    with torch.inference_mode():
        x, u = Tt["xu"][..., :nx], Tt["xu"][..., nx:]
        r_eq = al_core.eq_residuals_se(tdyn, x, u, Tt["x0"])
        _, F = tdyn_jac(x[:, :-1], u[:, :-1])
        blocks = al_core.merit_grad_blocks(Tt["xu"], Tt["Q"], Tt["q"], Tt["x0"], Tt["lam"],
                                           Tt["rho"], F, None, None, dyn_eq_res=r_eq,
                                           state_estimator=True)
        merit = al_core.merit_function(tdyn, Tt["xu"], Tt["Q"], Tt["q"], Tt["x0"], Tt["lam"],
                                       Tt["rho"], None, None, state_estimator=True)
    np.testing.assert_allclose(_np(r_eq), np.asarray(r_ref), **TOL)
    assert not _np(r_eq)[:, -1].any()  # the zero row in the initial-state slot
    for name, a, b in zip(("g", "D", "O", "res", "res_c"), blocks, blocks_ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL, err_msg=name)
    np.testing.assert_allclose(_np(merit), np.asarray(m_ref), **TOL)
    # block 0 has no S'S: its x-part is Q + rho F'F alone
    D0 = _np(blocks[1])[:, 0, :nx, :nx]
    Fx = _np(F)[:, 0, :, :nx]
    np.testing.assert_allclose(D0, np.eye(nx) * env.Qlqr + 10.0 * np.swapaxes(Fx, 1, 2) @ Fx,
                               rtol=1e-12, atol=1e-12)
    assert blocks[3].shape == (BSZ, H * nx)  # no control-box rows


def _jax_newton_vjp(p, g):
    newton = make_newton_al(JaxNewtonALConfig(nx=2, nu=1, T=H, state_estimator=True,
                                              tridiag_backend="xla"),
                            *_jax_fns(), None, None)
    J = {k: jnp.asarray(v) for k, v in p.items()}
    out, vjp = jax.vjp(lambda Q, q: newton(J["xu"], J["x0"], J["lam"], J["rho"], Q, q)[0],
                       J["Q"], J["q"])
    dQ, dq = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dQ), np.asarray(dq)


def _port_newton_vjp(env, p, g):
    newton = NewtonAL(NewtonALConfig(nx=env.nx, nu=env.nu, T=H, state_estimator=True),
                      *_torch_fns(env), None, None)
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    Q, q = t["Q"].requires_grad_(), t["q"].requires_grad_()
    out, _ = newton(t["xu"], t["x0"], t["lam"], t["rho"], Q, q)
    out.backward(torch.as_tensor(g))
    assert newton.backward_solves == 1
    return _np(out), _np(Q.grad), _np(q.grad), newton


@pytest.fixture(scope="module")
def mhe_cases():
    """(problem, cotangent, JAX reference) for the estimator's own cost and
    for one with a control weight."""
    cases = {}
    for name, u_weight in (("estimator_cost", 0.0), ("control_weight", 0.1)):
        env, p = _problem(1, u_weight)
        g = np.random.default_rng(7).normal(size=p["xu"].shape)
        cases[name] = (env, p, g, _jax_newton_vjp(p, g))
    return cases


def _check_newton(case):
    env, p, g, (out_ref, dQ_ref, dq_ref) = case
    out, dQ, dq, newton = _port_newton_vjp(env, p, g)
    np.testing.assert_allclose(out, out_ref, **TOL, err_msg="xu_out")
    np.testing.assert_allclose(dQ, dQ_ref, **TOL, err_msg="dQ")
    np.testing.assert_allclose(dq, dq_ref, **TOL, err_msg="dq")
    return out, dq, newton


@pytest.mark.parametrize("name", ["estimator_cost", "control_weight"])
def test_se_newton_and_backward_match_custom_vjp(mhe_cases, name):
    out, dq, newton = _check_newton(mhe_cases[name])
    p = mhe_cases[name][1]
    assert (np.abs(out - p["xu"]).max(axis=(1, 2)) > 1e-3).all()  # every sample moved
    if name == "estimator_cost":
        # no weight on the last knot's control: its block is singular, every
        # Newton step retries jittered, and the backward zeroes every sample
        assert newton.retries == newton.steps >= 1
        assert not dq.any() and int(newton.backward_zeroed) == BSZ
    else:
        assert newton.retries == 0 and int(newton.backward_zeroed) == 0
        assert (np.abs(dq).max(axis=(1, 2)) > 1e-3).all()


def test_planted_backward_with_block0_sts_fails(mhe_cases, monkeypatch):
    """The implicit backward's Hessian with the initial-state row's S'S
    kept on block 0 (the tracking solver's) must fail the check."""
    good = newton_al.implicit_grads

    def with_sts(D, O, xu_out, g_out):
        nx = 2
        D = D.clone()
        D[:, 0, :nx, :nx] += 10.0 * torch.eye(nx, dtype=D.dtype)
        return good(D, O, xu_out, g_out)

    monkeypatch.setattr(newton_al, "implicit_grads", with_sts)
    with pytest.raises(AssertionError):
        _check_newton(mhe_cases["control_weight"])


def _tracking_pair(T, state_estimator):
    env = make_env("pendulum")
    kw = dict(al_iter=2, state_estimator=state_estimator, rho_max=1e5)
    jtm = JaxTrackingMPC(JaxPendulum(), T, dtype=jnp.float64, **kw)
    jtm.ctrl._newton = jax.jit(jtm.ctrl._newton)
    ttm = TrackingMPC(env, T, dtype=torch.float64, device="cpu", **kw)
    return env, jtm, ttm


@pytest.mark.parametrize("mode", ["q_scaling", "state_estimator"])
def test_tracking_mpc_options_match_jax(mode):
    """TrackingMPC with the Q variant's scalings (T 5) and the EstPred
    estimator (horizon H): the solution, the duals, and the gradients of a
    seeded functional of it into the reference (and the scalings)."""
    T = 5 if mode == "q_scaling" else H
    env, jtm, ttm = _tracking_pair(T, mode == "state_estimator")
    assert ttm.ctrl.ncon == jtm.ctrl.ncon
    rng = np.random.default_rng(3)
    x_ref = 0.5 * rng.normal(size=(BSZ, T, env.nx))
    u_ref = rng.normal(size=(BSZ, T, env.nu))
    qs = np.abs(rng.normal(size=(BSZ, T))) if mode == "q_scaling" else None
    w = rng.normal(size=(BSZ, T, env.nx))

    def jax_fn(x_ref, q):
        x, u, _, st = jtm(x_ref[:, 0], x_ref, jnp.asarray(u_ref), jtm.init_state(BSZ),
                          q_scaling=q, al_iters=2)
        return jnp.sum(x * w), (x, u, st.lam)

    jargs = (jnp.asarray(x_ref), None if qs is None else jnp.asarray(qs))
    (val_ref, (x_j, u_j, lam_j)), grads_ref = jax.value_and_grad(
        jax_fn, argnums=(0, 1) if qs is not None else 0, has_aux=True)(*jargs)
    xt = torch.as_tensor(x_ref).requires_grad_()
    qt = None if qs is None else torch.as_tensor(qs).requires_grad_()
    x, u, _, st = ttm(xt[:, 0], xt, torch.as_tensor(u_ref), ttm.init_state(BSZ), al_iters=2,
                      q_scaling=qt)
    torch.sum(x * torch.as_tensor(w)).backward()
    for name, a, b in (("x", x, x_j), ("u", u, u_j), ("lam", st.lam, lam_j)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL, err_msg=name)
    g_x = grads_ref[0] if qs is not None else grads_ref
    np.testing.assert_allclose(_np(xt.grad), np.asarray(g_x), **TOL, err_msg="d x_ref")
    if qs is not None:
        np.testing.assert_allclose(_np(qt.grad), np.asarray(grads_ref[1]), **TOL,
                                   err_msg="d q_scaling")
        assert np.abs(_np(qt.grad)).max() > 1e-4
    else:
        # the estimator's states-only cost: zero weight on the controls
        assert not _np(ttm.Q0)[env.nx:].any()


def test_one_knot_estimator_fails_in_jax_as_in_the_port():
    """At H = 1 the estimator has no defect row: its residuals are empty
    beside its nx duals, and the JAX solve fails on the shapes. The port's
    fails the same way, and `build_policy` refuses estpred below H = 2
    (`tests/test_torch_variants_policy.py`)."""
    env, jtm, ttm = _tracking_pair(1, state_estimator=True)
    x_ref = np.zeros((BSZ, 1, env.nx))
    u_ref = np.zeros((BSZ, 1, env.nu))
    with pytest.raises(TypeError, match="broadcasting"):
        jtm(jnp.asarray(x_ref[:, 0]), jnp.asarray(x_ref), jnp.asarray(u_ref),
            jtm.init_state(BSZ))
    with pytest.raises(RuntimeError, match="size of tensor"):
        ttm(torch.as_tensor(x_ref[:, 0]), torch.as_tensor(x_ref), torch.as_tensor(u_ref),
            ttm.init_state(BSZ))
