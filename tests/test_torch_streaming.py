"""The port's streaming (warm-start, receding-horizon) path against the JAX
package in f64: `warm_start_shift`, the cost-history warm starts, the
streaming `ALMPC.solve` with its rho-cap exit, `solve_linearize_once` and
the NewtonAL Function on its linear model, the policy's cold tick and
warm ticks with their carry, the streaming training step's loss and
gradients, and `rexquad_streaming` at full width; then the warm-started
eval, the streaming train CLI and `bench_streaming` on the CPU.

Tolerances: exact (1e-15) for the shift, which only moves numbers; 1e-8
for the solves (rounding through at most 8 Newton steps, as in
`test_torch_al.py`); 1e-7 for the policy (three ticks of two rounds, as
the cold forward's parity in `test_torch_policy.py`); rtol 1e-9 for the
training step (as `test_torch_train.py`); the f64 tick limits of PERF.md
(median <= 1e-4, p75 <= 1e-3) at full width."""
import dataclasses
import functools
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deqmpc_tpu.envs import PendulumEnv as JaxPendulum  # noqa: E402
from deqmpc_tpu.envs import RexQuadrotor as JaxQuad  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import DEQMPCPolicy as JaxPolicy  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import PolicyConfig as JaxPolicyConfig  # noqa: E402
from deqmpc_tpu.solvers.al_mpc import ALMPC as JaxALMPC  # noqa: E402
from deqmpc_tpu.solvers.al_mpc import warm_start_al as jax_warm_start_al  # noqa: E402
from deqmpc_tpu.solvers.al_mpc import warm_start_al_stream as jax_warm_start_al_stream  # noqa: E402
from deqmpc_tpu.solvers.types import ALState as JaxALState  # noqa: E402
from deqmpc_tpu.solvers.types import LinDx as JaxLinDx  # noqa: E402
from deqmpc_tpu.solvers.types import QuadCost as JaxQuadCost  # noqa: E402
from deqmpc_tpu.training import train as jax_train  # noqa: E402
from deqmpc_tpu_torch import data as port_data  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.ops import block_tridiag as bt  # noqa: E402
from deqmpc_tpu_torch.policies import DEQMPCPolicy, PolicyConfig, build_policy  # noqa: E402
from deqmpc_tpu_torch.solvers import ALMPC, ALState, QuadCost  # noqa: E402
from deqmpc_tpu_torch.solvers.al_mpc import warm_start_al, warm_start_al_stream  # noqa: E402
from deqmpc_tpu_torch.training import bench_streaming, train  # noqa: E402
from deqmpc_tpu_torch.training import eval as port_eval  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint, params_from_jax  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
STREAMING_CKPT = REPO / "checkpoints" / "rexquad_streaming"
JAX_ENVS = {"pendulum": JaxPendulum, "rexquadrotor": JaxQuad}
T = 5
TOL = dict(rtol=1e-8, atol=1e-8)
POLICY_TOL = dict(rtol=1e-7, atol=1e-7)
STEP_TOL = dict(rtol=1e-9, atol=1e-11)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(ref), **tol, err_msg=msg)


# -- solvers ---------------------------------------------------------------------

def _solvers(env_name, rho_max=1e5, al_iter=2):
    """The same AL solver in both packages, f64."""
    env, jenv = make_env(env_name), JAX_ENVS[env_name]()

    def jdyn_jac(x, u):
        xn, (Jx, Ju) = jenv.dynamics_derivatives(x, u)
        return xn, jnp.concatenate([Jx, Ju], axis=-1)

    def tdyn_jac(x, u):
        xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
        return xn, torch.cat([Jx, Ju], dim=-1)

    lo, hi = env.action_space.low, env.action_space.high
    jctrl = JaxALMPC(env.nx, env.nu, T, lo, hi, jenv.dynamics, jdyn_jac, al_iter=al_iter,
                     rho_max=rho_max, dtype=jnp.float64, tridiag_backend="xla")
    jctrl._newton = jax.jit(jctrl._newton)  # compiled once for every AL iteration
    tctrl = ALMPC(env.nx, env.nu, T, lo, hi, env.dynamics, tdyn_jac, al_iter=al_iter,
                  rho_max=rho_max, dtype=torch.float64, device="cpu")
    return env, jctrl, tctrl


def _problem(env, bsz=4, seed=0, rho0=10.0):
    """A warm-started tracking problem: cost, x0 and an AL state whose
    iterate lies near the reference, with duals of both signs."""
    nx, nu = env.nx, env.nu
    lo, hi = env.action_space.low.astype(np.float64), env.action_space.high.astype(np.float64)
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.normal(size=(bsz, T, nx))
    u = (lo + hi) / 2 + 0.6 * (hi - lo) / 2 * rng.uniform(-1, 1, size=(bsz, T, nu))
    xu = np.concatenate([x, u], axis=-1)
    Q = np.broadcast_to(np.concatenate([env.Qlqr, np.full(nu, 0.1)]), xu.shape).copy()
    q = -Q * (xu + 0.2 * rng.normal(size=xu.shape))
    x0 = x[:, 0] + 0.1 * rng.normal(size=(bsz, nx))
    ncon = T * nx + 2 * nu * T
    lam = 0.1 * rng.normal(size=(bsz, ncon))
    lam[:, T * nx:] = np.abs(lam[:, T * nx:])
    state = dict(lam=lam, rho=np.full((bsz, 1), rho0), x=x + 0.05 * rng.normal(size=x.shape),
                 u=u, has_init=np.ones(bsz, bool))
    return dict(x0=x0, Q=Q, q=q, x_init=xu[..., :nx], u_init=xu[..., nx:]), state


def _jax_state(s):
    return JaxALState(**{k: jnp.asarray(v) for k, v in s.items()})


def _port_state(s):
    return ALState(**{k: torch.as_tensor(v) for k, v in s.items()})


def _costs(p):
    return (JaxQuadCost(jnp.asarray(p["Q"]), jnp.asarray(p["q"]), None),
            QuadCost(torch.as_tensor(p["Q"]), torch.as_tensor(p["q"]), None))


def _lam_tol(rho, tol=TOL):
    """The duals' tolerance: the dual step lam + rho*res multiplies the
    residual's rounding by rho (measured: 1.7e-7 at rho 1e3, with x within
    1.2e-9), so the absolute tolerance scales with the largest rho."""
    return dict(rtol=tol["rtol"], atol=tol["atol"] * max(1.0, float(np.nanmax(_np(rho)))))


def _check_state(got, ref, tol=TOL):
    for k in ("rho", "x", "u"):
        _close(getattr(got, k), getattr(ref, k), tol, msg=k)
    _close(got.lam, ref.lam, _lam_tol(ref.rho, tol), msg="lam")
    np.testing.assert_array_equal(_np(got.has_init), _np(ref.has_init))


def _check_history(got, ref):
    for a, b, name in zip(got, ref, ("cost", "lam", "rho")):
        _close(a, b, _lam_tol(ref[2]) if name == "lam" else TOL, msg=name)


def test_warm_start_shift_matches_jax_exactly():
    env, jctrl, tctrl = _solvers("rexquadrotor")
    _, s = _problem(env, bsz=5)
    nx = env.nx
    s["lam"][1, 2 * nx + 3] = np.nan  # moves to knot 1, and NaN * 0 stays NaN
    s["rho"][2] = 1e6             # clamped
    s["rho"][3] = np.nan
    s["has_init"][4] = False
    ref = jctrl.warm_start_shift(_jax_state(s), 1e2)
    got = tctrl.warm_start_shift(_port_state(s), 1e2)
    for k in ("lam", "rho", "x", "u"):
        np.testing.assert_allclose(_np(getattr(got, k)), _np(getattr(ref, k)), rtol=0,
                                   atol=1e-15, equal_nan=True, err_msg=k)
    assert np.flatnonzero(np.isnan(_np(got.lam))).tolist() == [got.lam.shape[1] + nx + 3]
    assert (_np(got.lam)[0] == 0).all() and _np(got.rho)[2, 0] == 1e2
    assert _np(got.has_init).all()


def test_warm_start_al_and_stream_match_jax():
    rng = np.random.default_rng(3)
    H, bsz, ncon = 4, 5, 7
    cost_hist = rng.uniform(0, 10, size=(H, bsz))
    cost_start = rng.uniform(0, 10, size=bsz)
    cost_start[0] = -1.0  # no entry below it: index 0, as jnp.argmax
    lam_hist = rng.normal(size=(H, bsz, ncon))
    rho_hist = 10.0 ** rng.integers(0, 6, size=(H, bsz, 1)).astype(np.float64)
    lam, rho = rng.normal(size=(bsz, ncon)), np.full((bsz, 1), 123.0)
    args = (lam, rho, cost_start, cost_hist, lam_hist, rho_hist)
    ref = jax_warm_start_al(*map(jnp.asarray, args))
    got = warm_start_al(*map(torch.as_tensor, args))
    for a, b in zip(got, ref):
        _close(a, b)
    stream_args = (rho, cost_start, cost_hist, rho_hist)
    _close(warm_start_al_stream(*map(torch.as_tensor, stream_args)),
           jax_warm_start_al_stream(*map(jnp.asarray, stream_args)))
    assert _np(got[1])[0, 0] == rho_hist[0, 0, 0]


def test_solve_history_and_warm_start_history_match_jax():
    env, jctrl, tctrl = _solvers("pendulum", rho_max=1e8)
    p, s = _problem(env, seed=5)
    s["has_init"][:] = False
    jcost, tcost = _costs(p)
    jx0, tx0 = jnp.asarray(p["x0"]), torch.as_tensor(p["x0"])
    init = dict(x_init=p["x_init"], u_init=p["u_init"])
    *ref, jhist = jctrl.solve(jx0, jcost, _jax_state(s), al_iter=3, return_history=True,
                              **{k: jnp.asarray(v) for k, v in init.items()})
    *got, thist = tctrl.solve(tx0, tcost, _port_state(s), al_iter=3, return_history=True,
                              **{k: torch.as_tensor(v) for k, v in init.items()})
    assert [tuple(h.shape) for h in thist] == [(4, 4), (4, 4, tctrl.ncon), (4, 4, 1)]
    _check_history(thist, jhist)
    _check_state(got[3], ref[3])
    # a nearby problem restarted from that history
    ref2 = jctrl.solve(jx0 + 0.01, jcost, ref[3], al_iter=2, warm_start_history=jhist)
    got2 = tctrl.solve(tx0 + 0.01, tcost, got[3], al_iter=2, warm_start_history=thist)
    for a, b, name in zip(got2[:2], ref2[:2], ("x", "u")):
        _close(a, b, msg=name)
    _check_state(got2[3], ref2[3])


@functools.lru_cache(maxsize=None)
def _streaming_solvers(env_name):
    """The streaming solve of 3 AL iterations in both packages."""
    env, jctrl, tctrl = _solvers(env_name, rho_max=1e5, al_iter=3)

    def jsolve(x0, Q, q, st):
        return jctrl.solve(x0, JaxQuadCost(Q, q, None), st, streaming=True, return_history=True)

    return env, jsolve, tctrl


@pytest.mark.parametrize("rho0", [10.0, 2e4])
@pytest.mark.parametrize("env_name", ["pendulum", "rexquadrotor"])
def test_streaming_solve_matches_jax(env_name, rho0):
    """Three AL iterations with the streaming exit. From rho 2e4 the
    uncapped update 2e5 exceeds rho_max 1e5 after the first iteration:
    the exit fires, and the iterate, duals and penalty stay frozen.
    At rho 2e4 the line search's merits tie within rounding: on one
    pendulum sample, Newton step 4's best candidates differ by 4e-16
    relative and the two packages pick different step sizes, a 2.4e-8
    move of u (the three steps before agree to 2e-16); that case is held
    to 1e-7."""
    env, jsolve, tctrl = _streaming_solvers(env_name)
    p, s = _problem(env, seed=int(rho0), rho0=rho0)
    _, tcost = _costs(p)
    ref = jsolve(*(jnp.asarray(p[k]) for k in ("x0", "Q", "q")), _jax_state(s))
    with torch.inference_mode():
        got = tctrl.solve(torch.as_tensor(p["x0"]), tcost, _port_state(s), streaming=True,
                          return_history=True)
    tol = TOL if rho0 < 1e4 else dict(rtol=1e-7, atol=1e-7)
    for a, b, name in zip(got[:2], ref[:2], ("x", "u")):
        _close(a, b, tol, msg=name)
    np.testing.assert_array_equal(_np(got[2]), _np(ref[2]))
    _check_state(got[3], ref[3], tol)
    _check_history(got[4], ref[4])
    stopped = rho0 * 10 > 1e5
    assert _np(got[2]).tolist() == [stopped] * 4
    lam_hist, rho_hist = _np(got[4][1]), _np(got[4][2])
    if stopped:
        assert (lam_hist[2] == lam_hist[1]).all() and (lam_hist[3] == lam_hist[1]).all()
        assert (rho_hist[1:] == 1e5).all()
    else:
        np.testing.assert_array_equal(rho_hist[:, 0, 0], [10.0, 100.0, 1e3, 1e4])


def _linearize_once_setup(case="rho_cap"):
    """"rho_cap": `tests/test_aux_components.py::test_linearize_once_streaming`,
    a nonlinear solve of 4 AL iterations, the receding-horizon shift (rho
    clamped to 1e2), then the linearize-once solve from the next state; rho
    reaches the cap 1e8 at iteration 6 of 8. "stall": the iterate is a
    rollout of the dynamics from x0 with controls inside the box, and the
    cost's minimum, so it already solves the linear model: no iteration
    lowers the residual, and the stall exit stops the loop at iteration 2."""
    env, jctrl, tctrl = _solvers("pendulum", rho_max=1e8)
    bsz, nx, nu = 4, env.nx, env.nu
    rng = np.random.default_rng(7)
    x0 = rng.uniform(-0.5, 0.5, (bsz, nx))
    Qd = np.tile(np.concatenate([env.Qlqr, env.Rlqr]), (bsz, T, 1))
    if case == "stall":
        u = rng.uniform(-1.0, 1.0, (bsz, T, nu))
        x = [torch.as_tensor(x0)]
        for t in range(T - 1):
            x.append(env.dynamics(x[-1], torch.as_tensor(u[:, t])))
        xu = np.concatenate([torch.stack(x, 1).numpy(), u], -1)
        p = dict(Q=Qd, q=-Qd * xu)
        s = dict(lam=np.zeros((bsz, tctrl.ncon)), rho=np.full((bsz, 1), 10.0), x=xu[..., :nx],
                 u=u, has_init=np.ones(bsz, bool))
        jcost, tcost = _costs(p)
        return env, {"jax": (jctrl, jcost, _jax_state(s), jnp.asarray(x0)),
                     "port": (tctrl, tcost, _port_state(s), torch.as_tensor(x0))}
    x_ref = np.tile(np.array([np.pi, 0.0]), (bsz, T, 1))
    q = -Qd * np.concatenate([x_ref, np.zeros((bsz, T, nu))], -1)
    jcost, tcost = _costs(dict(Q=Qd, q=q))
    out = {}
    for name, ctrl, cost, arr, dyn in (("jax", jctrl, jcost, jnp.asarray, JaxPendulum().dynamics),
                                       ("port", tctrl, tcost, torch.as_tensor, env.dynamics)):
        x, u, _, st = ctrl.solve(arr(x0), cost, ctrl.init_state(bsz), al_iter=4)
        out[name] = (ctrl, cost, ctrl.warm_start_shift(st, 1e2), dyn(x[:, 0], u[:, 0]))
    return env, out


@pytest.mark.parametrize("case", ["rho_cap", "stall"])
def test_solve_linearize_once_matches_jax(case):
    env, out = _linearize_once_setup(case)
    jctrl, jcost, jst, jx0 = out["jax"]
    tctrl, tcost, tst, tx0 = out["port"]
    _check_state(tst, jst)
    ref = jctrl.solve_linearize_once(jx0, jcost, jst)
    with torch.inference_mode():
        got = tctrl.solve_linearize_once(tx0, tcost, tst)
    for a, b, name in zip(got[:2], ref[:2], ("x", "u")):
        _close(a, b, msg=name)
    np.testing.assert_array_equal(_np(got[2]), _np(ref[2]))
    _check_state(got[3], ref[3])
    lin = tctrl.linearize(tst)
    _close(lin.F, jctrl._lin_current.F, msg="F")
    _close(lin.f, jctrl._lin_current.f, msg="f")
    assert _np(got[2]).all()
    # rho went up 10x per iteration until the exit: to the cap, or two steps
    rho_end = 1e8 if case == "rho_cap" else 1e3
    np.testing.assert_array_equal(_np(got[3].rho), rho_end)


def test_newton_function_on_the_linear_model_matches_custom_vjp():
    env, out = _linearize_once_setup()
    jctrl, jcost, jst, jx0 = out["jax"]
    tctrl, tcost, tst, tx0 = out["port"]
    lin = tctrl.linearize(tst)
    jctrl._lin_current = JaxLinDx(F=jnp.asarray(_np(lin.F)), f=jnp.asarray(_np(lin.f)))
    xu = np.concatenate([_np(tst.x), _np(tst.u)], axis=-1)
    lam, rho = _np(tst.lam), _np(tst.rho)
    g = np.random.default_rng(9).normal(size=xu.shape)
    J = [jnp.asarray(a) for a in (xu, _np(tx0), lam, rho)]
    out_ref, vjp = jax.vjp(lambda Q, q: jctrl._newton_lin(*J, Q, q)[0], jcost.Q, jcost.q)
    dQ_ref, dq_ref = vjp(jnp.asarray(g))
    newton = tctrl.newton.with_dynamics(*ALMPC.linear_dynamics(lin))
    Q, q = tcost.Q.clone().requires_grad_(), tcost.q.clone().requires_grad_()
    xu_out, _ = newton(*(torch.as_tensor(a) for a in (xu, _np(tx0), lam, rho)), Q, q)
    xu_out.backward(torch.as_tensor(g))
    _close(xu_out, out_ref, msg="xu_out")
    _close(Q.grad, dQ_ref, msg="dQ")
    _close(q.grad, dq_ref, msg="dq")
    assert np.abs(_np(q.grad)).max() > 1e-3
    # the derived solver counts into the solver it came from
    assert tctrl.newton.backward_solves == 1 and tctrl.newton.steps >= newton.steps > 0


# -- the policy -------------------------------------------------------------------

class _Jitted:
    """A JAX module whose __call__ is jitted once."""

    def __init__(self, module):
        self._module, self._call = module, jax.jit(module.__call__)

    def __call__(self, *args):
        return self._call(*args)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _jit_pieces(jpol):
    """XLA takes minutes to compile a whole RexQuadrotor forward: jit the
    network call and the NewtonAL solve alone, once each, for every round and
    tick (the rest of the JAX forward runs op by op)."""
    jpol.model = _Jitted(jpol.model)
    jpol.tracking_mpc.ctrl._newton = jax.jit(jpol.tracking_mpc.ctrl._newton)
    return jpol



HDIM, N, BSZ, L = 32, 2, 4, 2


def _f64_params(policy, seed):
    params = policy.init(jax.random.PRNGKey(seed))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(leaf, np.float64) + 0.05 * rng.normal(size=leaf.shape)
              for leaf in leaves]
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(v) for v in leaves])


def _pendulum_policies(linearize_once=False, seed=5):
    env = make_env("pendulum")
    kw = dict(nx=env.nx, nu=env.nu, nq=1, T=T, dt=env.dt, hdim=HDIM, deq_iter=N, rho_max=1e5,
              linearize_once=linearize_once)
    jpol = JaxPolicy(JaxPolicyConfig(**kw, solver_dtype=jnp.float64), JaxPendulum())
    params = _f64_params(jpol, seed)
    _jit_pieces(jpol)
    pol = DEQMPCPolicy(PolicyConfig(**kw, solver_dtype=torch.float64), env, device="cpu")
    pol.model.double()  # before loading: the f64 params must not pass through f32
    pol.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    assert pol.rho_warm_max == jpol.rho_warm_max == 10.0
    return env, jpol, params, pol


def _check_carry(got, ref, tol=POLICY_TOL):
    for k in ("z", "x", "u"):
        _close(getattr(got, k), getattr(ref, k), tol, msg=f"carry {k}")
    _check_state(got.solver, ref.solver, tol)
    assert not any(getattr(got, k).requires_grad for k in ("z", "x", "u"))


@pytest.mark.parametrize("linearize_once", [False, True])
def test_policy_cold_and_warm_ticks_match_jax(linearize_once):
    env, jpol, params, pol = _pendulum_policies(linearize_once)
    obs = env.reset(torch.Generator().manual_seed(1), BSZ, device="cpu", dtype=torch.float64)
    noise = 0.05 * torch.randn((3, BSZ, env.nx), generator=torch.Generator().manual_seed(2),
                               dtype=torch.float64)
    ref_out, ref_carry = jpol.forward(params, jnp.asarray(obs.numpy()))
    with torch.inference_mode():
        out = pol.forward(obs)
    warm_ref = jpol.forward_warm_start
    for tick in range(3):
        # tick 2 meets rounding amplified past 1e-7: a 1e-14 relative move of
        # the observations moves JAX's own tick-2 actions by 1.1e-6 and
        # 7.8e-5 (the port is 1.3e-6 from JAX there); ticks 0 and 1, and
        # the carry into tick 2, are held to 1e-7
        tol = POLICY_TOL if tick < 2 else dict(rtol=1e-5, atol=1e-5)
        for i, (got, ref) in enumerate(zip(out["trajs"], ref_out["trajs"])):
            for name, a, b in zip(("x_ref", "x", "u"), got, ref):
                _close(a, b, tol, msg=f"tick {tick} round {i} {name}")
        np.testing.assert_array_equal(_np(out["status"]), _np(ref_out["status"]))
        _close(out["init_states"], ref_out["init_states"], POLICY_TOL)
        _check_carry(out["carry"], ref_carry, tol)
        if tick == 2:
            break
        obs_next = obs + noise[tick]
        ref_out, ref_carry = warm_ref(params, jnp.asarray(obs_next.numpy()), ref_carry)
        with torch.inference_mode():
            out = pol.forward_warm_start(obs_next, out["carry"])
    # the warm ticks ran the streaming solve: rho starts from rho_warm_max
    assert _np(out["carry"].solver.rho).max() <= 1e5


def _streaming_batch(env):
    gt, _ = train.split_episodes(port_data.get_gt_data(env)[:40])
    batch = port_data.sample_trajectory(gt, BSZ, 1, T + L, np.random.default_rng(11))
    return train.preprocess_batch("pendulum", env.nx, batch)


def test_streaming_train_step_loss_and_gradients_match_jax():
    env, jpol, params, pol = _pendulum_policies(seed=6)
    batch = _streaming_batch(env)
    assert batch["state"].shape[1] == T + L
    opt = optax.chain(optax.clip_by_global_norm(2.0), optax.adam(1e-3))
    _, loss_fn = jax_train.make_streaming_train_step(
        jpol, opt, types.SimpleNamespace(streaming_steps=L, T=T, qp_solve=True))
    jbatch = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in batch.items()}
    (loss_ref, aux), grads_ref = jax.value_and_grad(loss_fn, has_aux=True)(
        params, jbatch, jnp.ones((N, 3)))
    d = train.make_loss_fn(L)(pol, train.to_device(batch, "cpu", torch.float64))
    d["loss"].backward()
    assert pol.backward_solves == N * (1 + L)  # one implicit backward per round
    _close(d["loss"], loss_ref, STEP_TOL)
    _close(d["loss_end"], aux["loss_end"], STEP_TOL)
    for k in ("losses_iter", "losses_iter_opt", "losses_iter_nn"):
        _close(d[k], aux[k], STEP_TOL, msg=k)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads_ref))
    got = dict(pol.model.named_parameters())
    assert set(ref) == set(got)
    for name, g_ref in ref.items():
        if name == "iter_emb":  # unused by the base forward
            assert got[name].grad is None and not g_ref.numpy().any()
            continue
        # rtol 1e-9 of each entry, or 1e-9 of the tensor's largest entry:
        # the warm ticks' solves at rho up to 1e5 leave gaps of 1.5e-10 on
        # entries near 0 (out.Conv_0.kernel, largest entry 2.4); a 1e-14
        # relative move of the batch moves JAX's own gradient by 2.1e-10
        tol = dict(rtol=STEP_TOL["rtol"], atol=STEP_TOL["rtol"] * float(g_ref.abs().max()))
        _close(got[name].grad, g_ref, tol, msg=name)
    assert np.abs(_np(got["out.Conv_1.kernel"].grad)).max() > 1e-4


def test_rexquad_streaming_ticks_match_jax_in_f64():
    """`rexquad_streaming` at full width (hdim 256, N 6), loaded by each
    package's own reader: tick 0 and one warm tick of 4 seeded start states
    in f64; the first actions of both ticks within the f64 tick limits.
    With 2 states the median is the mean of two, and one of them is chaotic
    at the warm tick: JAX's own first action there moves by up to 5.2e-4
    under a 1e-14 move of the observations, and by 8e-3 between two XLA
    compile settings."""
    state, args = load_checkpoint(STREAMING_CKPT, "cpu")
    assert args["streaming"] and args["streaming_steps"] == 2
    env = make_env(args["env"])
    cfg = build_policy(args, env, "cpu").cfg
    assert (cfg.hdim, cfg.deq_iter, cfg.T, cfg.rho_max) == (256, 6, 5, 1e5)
    pol = DEQMPCPolicy(dataclasses.replace(cfg, solver_dtype=torch.float64), env, device="cpu")
    pol.model.double()
    pol.model.load_state_dict(state)
    jpol = JaxPolicy(JaxPolicyConfig(nx=env.nx, nu=env.nu, nq=cfg.nq, T=cfg.T, dt=env.dt,
                                     hdim=cfg.hdim, deq_iter=cfg.deq_iter, rho_max=cfg.rho_max,
                                     rho_init_max=cfg.rho_init_max,
                                     solver_dtype=jnp.float64), JaxQuad())
    params, _, _, _ = jax_train.load_checkpoint(str(STREAMING_CKPT),
                                                jpol.init(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    _jit_pieces(jpol)
    obs = env.reset(torch.Generator().manual_seed(3), 4, device="cpu", dtype=torch.float64)
    ref_out, ref_carry = jpol.forward(params, jnp.asarray(obs.numpy()))
    with torch.inference_mode():
        out = pol.forward(obs)
        u0 = out["trajs"][-1][2][:, 0]
        obs1, _ = env.step(obs, u0)
        out1 = pol.forward_warm_start(obs1, out["carry"])
    ref_out1, _ = jpol.forward_warm_start(params, jnp.asarray(obs1.numpy()), ref_carry)
    gaps = [np.abs(_np(o["trajs"][-1][2][:, 0]) - np.asarray(r["trajs"][-1][2][:, 0])).max(-1)
            for o, r in ((out, ref_out), (out1, ref_out1))]
    for gap in gaps:
        assert np.median(gap) <= 1e-4 and np.quantile(gap, 0.75) <= 1e-3, gaps
    assert np.isfinite(_np(out1["trajs"][-1][2])).all()


# -- entry points on the CPU ----------------------------------------------------------

def test_eval_is_warm_started_for_a_streaming_checkpoint():
    state, args = load_checkpoint(STREAMING_CKPT, "cpu")
    env = make_env(args["env"])
    policy = build_policy(args, env, "cpu")
    policy.model.load_state_dict(state)
    calls = {"cold": 0, "warm": 0}
    cold, warm = policy.forward, policy.forward_warm_start
    policy.forward = lambda *a: (calls.__setitem__("cold", calls["cold"] + 1), cold(*a))[1]
    policy.forward_warm_start = lambda *a: (calls.__setitem__("warm", calls["warm"] + 1),
                                            warm(*a))[1]
    res = port_eval.eval_policy(args, env, policy, n_episodes=2, ep_len=2, device="cpu")
    assert calls == {"cold": 1, "warm": 1}
    assert res["warm_start"] and res["n_nan_episodes"] == 0
    assert res["tick_s_cold"] > 0 and res["tick_s_warm_median"] > 0
    res = port_eval.eval_policy(args, env, policy, n_episodes=2, ep_len=2, device="cpu",
                                warm_start=False)
    assert calls == {"cold": 3, "warm": 1} and res["tick_s_warm_median"] is None


def test_streaming_schedule_and_train_cli_on_cpu(tmp_path):
    for dtype, rho_max in (("float32", None), ("double", None)):
        a = train.parse_args(["--streaming", "--streaming_steps", "2"])
        a.dtype = dtype
        assert train.streaming_schedule(a) == 6 + 3 * 2 and a.str_al_iter == 3
    a = train.parse_args(["--streaming", "--streaming_start_iter", "5"])
    assert train.streaming_schedule(a) == 6
    res = train.main(["--env", "pendulum", "--T", "5", "--deq_iter", "2", "--hdim", "16",
                      "--bsz", "4", "--max_train_steps", "2", "--val_every", "2",
                      "--streaming", "--streaming_steps", "2", "--streaming_start_iter", "0",
                      "--device", "cpu", "--save", "--name", "s", "--models_dir", str(tmp_path),
                      "--logdir", str(tmp_path / "logs")])
    assert res["total_deq_iter"] == 2 + 2 * 2 and res["streaming_steps"] == 2
    assert [r["streaming"] for r in res["curve"]] == [True]
    assert all(np.isfinite(r["loss_avg"]) and np.isfinite(r["val_loss_end"])
               for r in res["curve"])
    # the port checkpoint says streaming, so its eval is warm-started
    stats = port_eval.main(["--ckpt", str(tmp_path / "s"), "--episodes", "2", "--ep_len", "2",
                            "--device", "cpu"])
    assert stats["warm_start"] and stats["n_nan_episodes"] == 0


def test_bench_streaming_prints_its_line_on_cpu(capsys):
    before = bt.block_tridiag_solve.launches
    out = bench_streaming.main(["--env", "pendulum", "--hdim", "16", "--deq_iter", "2",
                                "--str_deq_iter", "1", "--fleet_bsz", "3", "--n_rep", "1",
                                "--n_warmup", "0", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    for tag, bsz in (("single", 1), ("fleet", 3)):
        r = out[tag]
        assert r["bsz"] == bsz and r["cold_ms"] > 0 and r["warm_ms_per_tick"] > 0
        assert r["realtime_margin"] == pytest.approx(out["control_period_ms"]
                                                     / r["warm_ms_per_tick"])
    assert bt.block_tridiag_solve.launches == before  # the CPU runs the plain solve
