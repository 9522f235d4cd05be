"""The cost refresh between AL iterations (`recompute_Qq`) and the tracking
solve's auxiliary cost, the port against the JAX package in f64:
`ALMPC.solve(compute_Qq=...)` against JAX's and against the eager two-step
solve of `tests/test_recompute_qq.py` (one AL iteration, the cost refreshed
by hand, one more from the carried state); the identity refresh; the
policy forward with `recompute_Qq` (base and mem, whose refresh runs the
round's network on the solver's iterate) with the rounds' solver stats;
`TrackingMPC(aux_cost=...)` with a per-sample `q_mask`, alone and under the
refresh, its outputs and the gradient into the reference (none under the
refresh, whose last AL iteration tracks a detached cost); and the refusal
of the refresh on the linearize-once streaming path.

Tolerances: 1e-10 for the solves (the same arithmetic, as the two-step
reference in JAX's own test); 1e-7 for the policy forwards (two rounds of
Anderson and two AL iterations, as the base policy's parity); 1e-8 for the
tracking solve and its gradient (as `test_torch_mhe.py`'s TrackingMPC
rows). A forward that drops the refresh (planted) fails the policy check."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.envs import PendulumEnv as JaxPendulum  # noqa: E402
from deqmpc_tpu.policies import policy_variants as jax_pv  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import DEQMPCPolicy as JaxPolicy  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import PolicyConfig as JaxPolicyConfig  # noqa: E402
from deqmpc_tpu.policies.tracking_mpc import TrackingMPC as JaxTrackingMPC  # noqa: E402
from deqmpc_tpu.solvers import ALMPC as JaxALMPC  # noqa: E402
from deqmpc_tpu.solvers import QuadCost as JaxQuadCost  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.policies import build_policy  # noqa: E402
from deqmpc_tpu_torch.policies.tracking_mpc import TrackingMPC  # noqa: E402
from deqmpc_tpu_torch.solvers import ALMPC, QuadCost  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import params_from_jax  # noqa: E402

torch.set_num_threads(2)

SOLVE_TOL = dict(rtol=1e-10, atol=1e-10)
POLICY_TOL = dict(rtol=1e-7, atol=1e-7)
TRACK_TOL = dict(rtol=1e-8, atol=1e-8)
BSZ, T, HDIM, N = 4, 5, 32, 2
GOAL = np.array([np.pi, 0.0])


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# -- ALMPC.solve with the refresh ---------------------------------------------------------

def _solvers():
    """The pendulum AL solver in both, f64, with the problem of
    `tests/test_recompute_qq.py`: start states near the bottom, the goal
    upright."""
    env, jenv = make_env("pendulum"), JaxPendulum()
    nx, nu = env.nx, env.nu
    rng = np.random.default_rng(11)
    x0 = rng.uniform(-0.4, 0.4, (BSZ, nx))
    Qd = np.tile(np.concatenate([env.Qlqr, env.Rlqr]), (BSZ, T, 1))
    q0 = -Qd * np.concatenate([np.tile(GOAL, (BSZ, T, 1)), np.zeros((BSZ, T, nu))], -1)

    def jdyn_jac(x, u):
        xn, (Jx, Ju) = jenv.dynamics_derivatives(x, u)
        return xn, jnp.concatenate([Jx, Ju], -1)

    def dyn_jac(x, u):
        xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
        return xn, torch.cat([Jx, Ju], -1)

    box = (env.action_space.low, env.action_space.high)
    jmpc = JaxALMPC(nx, nu, T, *box, dyn=jenv.dynamics, dyn_jac=jdyn_jac, dtype=jnp.float64)
    jmpc._newton = jax.jit(jmpc._newton)
    mpc = ALMPC(nx, nu, T, *box, dyn=env.dynamics, dyn_jac=dyn_jac, dtype=torch.float64,
                device="cpu")
    return jmpc, mpc, x0, Qd, q0


def _net(lib, xu):
    """A stand-in network: a blend of the goal and the iterate."""
    lead = tuple(xu.shape[:2])
    goal = np.concatenate([np.tile(GOAL, lead + (1,)), np.zeros(lead + (1,))], -1)
    return 0.7 * (jnp.asarray(goal) if lib == "jax" else torch.as_tensor(goal)) + 0.3 * xu


def _refresh(lib, Qd):
    Q = jnp.asarray(Qd) if lib == "jax" else torch.as_tensor(Qd)
    return lambda xu: (Q, -Q * _net(lib, xu))


def _port_solve(mpc, x0, Q, q, al_iter, compute_Qq=None, state=None):
    f = torch.zeros(BSZ, T, dtype=torch.float64)
    cost = QuadCost(Q=torch.as_tensor(Q), q=torch.as_tensor(q), f=f)
    state = mpc.init_state(BSZ) if state is None else state
    return mpc.solve(torch.as_tensor(x0), cost, state, al_iter=al_iter, compute_Qq=compute_Qq)


@pytest.mark.parametrize("al_iter", [2, 3])
def test_solve_with_cost_refresh_matches_jax(al_iter):
    jmpc, mpc, x0, Qd, q0 = _solvers()
    cost = JaxQuadCost(Q=jnp.asarray(Qd), q=jnp.asarray(q0), f=jnp.zeros((BSZ, T)))
    xr, ur, _, sr = jmpc.solve(jnp.asarray(x0), cost, jmpc.init_state(BSZ), al_iter=al_iter,
                               compute_Qq=_refresh("jax", Qd))
    x, u, _, s = _port_solve(mpc, x0, Qd, q0, al_iter, _refresh("torch", Qd))
    for a, b in ((x, xr), (u, ur), (s.lam, sr.lam), (s.rho, sr.rho)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **SOLVE_TOL)
    # the refresh moved the solve
    x_plain, _, _, _ = _port_solve(mpc, x0, Qd, q0, al_iter)
    assert float((x - x_plain).abs().max()) > 1e-3


def test_solve_with_cost_refresh_matches_the_eager_two_step():
    _, mpc, x0, Qd, q0 = _solvers()
    refresh = _refresh("torch", Qd)
    xA, uA, _, _ = _port_solve(mpc, x0, Qd, q0, 2, refresh)
    x1, u1, _, st1 = _port_solve(mpc, x0, Qd, q0, 1)
    Q1, q1 = refresh(torch.cat([x1, u1], -1))
    xB, uB, _, _ = _port_solve(mpc, x0, Q1, q1, 1, state=st1)
    np.testing.assert_allclose(_np(xA), _np(xB), **SOLVE_TOL)
    np.testing.assert_allclose(_np(uA), _np(uB), **SOLVE_TOL)


def test_identity_refresh_is_a_noop():
    _, mpc, x0, Qd, q0 = _solvers()
    xA, uA, _, _ = _port_solve(mpc, x0, Qd, q0, 3)
    Q, q = torch.as_tensor(Qd), torch.as_tensor(q0)
    xB, uB, _, _ = _port_solve(mpc, x0, Qd, q0, 3, lambda xu: (Q, q))
    np.testing.assert_allclose(_np(xA), _np(xB), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(uA), _np(uB), rtol=0, atol=1e-12)


# -- the policy with the refresh ----------------------------------------------------------

def _policy_pair(variant, recompute_port=True):
    env = make_env("pendulum")
    kw = dict(nx=env.nx, nu=env.nu, nq=1, T=T, dt=env.dt, hdim=HDIM, deq_iter=N, rho_max=1e5,
              fp_max_steps=6)
    cls = {"base": JaxPolicy, "mem": jax_pv.DEQMPCPolicyMem}[variant]
    jpol = cls(JaxPolicyConfig(**kw, solver_dtype=jnp.float64, recompute_Qq=True), JaxPendulum())
    params = jpol.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64) + 0.05 * rng.normal(size=a.shape)),
        params)
    pol = build_policy({"T": T, "hdim": HDIM, "deq_iter": N, "nq": 1, "rho_max": 1e5,
                        "dtype": "double", "max_steps": 6, "policy_variant": variant,
                        "recompute_Qq": recompute_port}, env, "cpu")
    pol.model.double().load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                              params)))
    obs = env.reset(torch.Generator().manual_seed(3), BSZ, device="cpu", dtype=torch.float64)
    return jpol, params, pol, obs


def _check_policy(variant, recompute_port=True):
    jpol, params, pol, obs = _policy_pair(variant, recompute_port)
    ref, _ = jax.jit(jpol.forward)(params, jnp.asarray(obs.numpy()))
    with torch.inference_mode():
        out = pol.forward(obs)
    for i, (got, r) in enumerate(zip(out["trajs"], ref["trajs"])):
        for key, a, b in zip(("x_ref", "x", "u"), got, r):
            np.testing.assert_allclose(_np(a), np.asarray(b), **POLICY_TOL,
                                       err_msg=f"round {i} {key}")
    for key in ("fwd_err", "fwd_steps"):
        np.testing.assert_allclose(_np(out["deq_stats"][key]),
                                   np.asarray(ref["deq_stats"][key]), **POLICY_TOL, err_msg=key)


@pytest.mark.parametrize("variant", ["base", "mem"])
def test_policy_forward_with_recompute_matches_jax(variant):
    _check_policy(variant)


def test_planted_dropped_refresh_fails_the_policy_check():
    with pytest.raises(AssertionError):
        _check_policy("base", recompute_port=False)


# -- the tracking solve's auxiliary cost -----------------------------------------------------

def _tracking_inputs():
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-0.4, 0.4, (BSZ, 2))
    x_ref = np.concatenate([x0[:, None], rng.normal(size=(BSZ, T - 1, 2))], axis=1)
    u_ref = 0.1 * rng.normal(size=(BSZ, T, 1))
    aux_Q = np.array([2.0, 0.5, 0.3])
    aux_x = np.concatenate([GOAL, [0.0]])
    q_mask = np.array([1.0, 0.0, 1.0, 0.0])
    G = rng.normal(size=(BSZ, T, 2))
    return x0, x_ref, u_ref, (aux_Q, aux_x), q_mask, G


@pytest.mark.parametrize("refresh", [False, True])
def test_tracking_aux_cost_matches_jax(refresh):
    """Outputs and the gradient of <x, G> into x_ref, with the aux pull
    masked off on two samples; with the refresh, the masked pull is added
    again to each refreshed linear term."""
    x0, x_ref, u_ref, aux, q_mask, G = _tracking_inputs()
    jenv, env = JaxPendulum(), make_env("pendulum")
    jtm = JaxTrackingMPC(jenv, T, dtype=jnp.float64, rho_max=1e5, aux_cost=aux)
    tm = TrackingMPC(env, T, dtype=torch.float64, rho_max=1e5, aux_cost=aux, device="cpu")

    def jax_loss(xr):
        mc = (lambda xu: _net("jax", xu)) if refresh else None
        x, u, _, _ = jtm(jnp.asarray(x0), xr, jnp.asarray(u_ref), jtm.init_state(BSZ),
                         q_mask=jnp.asarray(q_mask), model_call=mc)
        return jnp.sum(x * jnp.asarray(G)), (x, u)

    (_, (xr_, ur_)), g_ref = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(x_ref))
    xr_t = torch.tensor(x_ref, requires_grad=True)
    x, u, _, _ = tm(torch.as_tensor(x0), xr_t, torch.as_tensor(u_ref), tm.init_state(BSZ),
                    q_mask=torch.as_tensor(q_mask),
                    model_call=(lambda xu: _net("torch", xu)) if refresh else None)
    np.testing.assert_allclose(_np(x), np.asarray(xr_), **TRACK_TOL)
    np.testing.assert_allclose(_np(u), np.asarray(ur_), **TRACK_TOL)
    if refresh:
        # the last AL iteration tracks the refreshed, detached cost: no
        # gradient reaches the reference, in JAX as here
        assert not x.requires_grad and not np.asarray(g_ref).any()
    else:
        torch.sum(x * torch.as_tensor(G)).backward()
        np.testing.assert_allclose(xr_t.grad.numpy(), np.asarray(g_ref), **TRACK_TOL)
    # the mask matters: the unmasked pull moves the solve
    x_all, _, _, _ = tm(torch.as_tensor(x0), torch.as_tensor(x_ref), torch.as_tensor(u_ref),
                        tm.init_state(BSZ))
    assert float((x_all - x).detach().abs().max()) > 1e-4


def test_linearize_once_streaming_refuses_the_refresh():
    env = make_env("pendulum")
    tm = TrackingMPC(env, T, dtype=torch.float64, rho_max=1e5, device="cpu")
    x0, x_ref, u_ref, _, _, _ = _tracking_inputs()
    with pytest.raises(ValueError, match="recompute_Qq"):
        tm(torch.as_tensor(x0), torch.as_tensor(x_ref), torch.as_tensor(u_ref),
           tm.init_state(BSZ), streaming=True, linearize_once=True,
           model_call=lambda xu: _net("torch", xu))
