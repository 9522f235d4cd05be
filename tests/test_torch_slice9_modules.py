"""The small modules of slice 9, the port against the JAX package in f64:
`IntegratorEnv` and the `integrator` name; `Env.finite_diff_derivatives`
and `Env.rollout` for every env; `ALMPC.kkt_residuals`; `solvers/util.py`
(`get_traj` on a `LinDx` and on a dynamics callable, `get_cost`,
`check_fd_grads`); `utils.merge_args`; `utils/profiling.PhaseTimer`;
`training/profile_step.py`'s keys; the eval's start window
(`eval_x_window`, `RexQuadrotor.reset(x_window=)`) and
`check_param_sensitivity`.

Tolerances: dynamics, Jacobians, finite differences (eps 1e-4; at the
default 1e-6, 10 ulps of the dynamics over 2 eps), rollouts and the
utilities at 1e-10 (the same arithmetic); `kkt_residuals` at 1e-8;
the sensitivity losses at 1e-9 (two AL iterations in each of two rounds);
`merge_args` and `PhaseTimer` exactly."""
import argparse
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu import utils as jax_utils  # noqa: E402
from deqmpc_tpu.envs import make_env as jax_make_env  # noqa: E402
from deqmpc_tpu.solvers import util as jax_util  # noqa: E402
from deqmpc_tpu.solvers.al_mpc import ALMPC as JaxALMPC  # noqa: E402
from deqmpc_tpu.solvers.types import LinDx as JaxLinDx  # noqa: E402
from deqmpc_tpu.solvers.types import QuadCost as JaxQuadCost  # noqa: E402
from deqmpc_tpu.training import eval as jax_eval  # noqa: E402
from deqmpc_tpu.training import profile_step as jax_profile_step  # noqa: E402
from deqmpc_tpu.utils import profiling as jax_profiling  # noqa: E402
from deqmpc_tpu_torch import utils  # noqa: E402
from deqmpc_tpu_torch.envs import IntegratorEnv, make_env  # noqa: E402
from deqmpc_tpu_torch.policies import build_policy  # noqa: E402
from deqmpc_tpu_torch.solvers import (ALMPC, LinDx, QuadCost, check_fd_grads,  # noqa: E402
                                      get_cost, get_traj)
from deqmpc_tpu_torch.training import eval as port_eval  # noqa: E402
from deqmpc_tpu_torch.training import profile_step  # noqa: E402
from deqmpc_tpu_torch.utils import profiling  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import params_from_jax  # noqa: E402
from deqmpc_tpu_torch.utils.rotations import euler_to_quaternion, quat2mrp  # noqa: E402
from torch_variant_pairs import pair, pendulum_batch  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-10)
ENVS = ["pendulum", "integrator", "cartpole1link", "cartpole2link", "rexquadrotor",
        "FlyingCartpole"]


def _states(env, bsz, seed):
    """Start states of the port's env (f64), and controls inside its box."""
    rng = np.random.default_rng(seed)
    x = env.reset(torch.Generator().manual_seed(seed), bsz, device="cpu",
                  dtype=torch.float64).numpy()
    lo, hi = env.action_space.low.astype(np.float64), env.action_space.high.astype(np.float64)
    u = lo + (hi - lo) * rng.uniform(0.25, 0.75, size=(bsz, env.nu))
    return x, u


# -- envs -------------------------------------------------------------------------

def test_integrator_matches_jax():
    env, jenv = make_env("integrator"), jax_make_env("integrator")
    assert isinstance(env, IntegratorEnv)
    for key in ("nx", "nu", "nq", "dt", "_max_episode_steps", "spec_id"):
        assert getattr(env, key) == getattr(jenv, key), key
    for key in ("Qlqr", "Rlqr", "targ_pos"):
        np.testing.assert_array_equal(getattr(env, key), getattr(jenv, key))
    np.testing.assert_array_equal(env.action_space.low, jenv.action_space.low)
    x, u = _states(env, 6, 0)
    assert (np.abs(x) <= 2.0).all()
    xn, (Jx, Ju) = env.dynamics_derivatives(torch.as_tensor(x), torch.as_tensor(u))
    jxn, (jJx, jJu) = jenv.dynamics_derivatives(jnp.asarray(x), jnp.asarray(u))
    for a, b in ((xn, jxn), (Jx, jJx), (Ju, jJu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    r = env.reward(torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(r.numpy(), np.asarray(jenv.reward(jnp.asarray(x), jnp.asarray(u))),
                               **TOL)
    xs, rs = env.step(torch.as_tensor(x), torch.as_tensor(3 * u))  # clipped to the box
    jxs, jrs = jenv.step(jnp.asarray(x), jnp.asarray(3 * u))
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), **TOL)


@pytest.mark.parametrize("name", ENVS)
def test_finite_diff_derivatives_and_rollout_match_jax(name):
    env, jenv = make_env(name), jax_make_env(name)
    x, u = _states(env, 3, 1)
    # The two packages' RK4 steps may round apart in the last bit, and a
    # difference quotient turns one ulp of f into ulp(f) / (2 eps): 1.1e-10
    # at the default eps 1e-6. So the quotients are held at 1e-10 with
    # eps 1e-4, and at the default eps within 10 ulps of f over 2 eps (the
    # n-link cartpole's mass-matrix solve rounds apart by up to 6).
    xn = np.abs(np.asarray(jenv.dynamics(jnp.asarray(x), jnp.asarray(u)))).max()
    for eps, atol in ((1e-4, 1e-10), (1e-6, 10 * np.spacing(xn) / 2e-6)):
        Jx, Ju = env.finite_diff_derivatives(torch.as_tensor(x), torch.as_tensor(u), eps=eps)
        jJx, jJu = jenv.finite_diff_derivatives(jnp.asarray(x), jnp.asarray(u), eps=eps)
        assert Jx.shape == (3, env.nx, env.nx) and Ju.shape == (3, env.nx, env.nu)
        np.testing.assert_allclose(Jx.numpy(), np.asarray(jJx), rtol=1e-10, atol=atol)
        np.testing.assert_allclose(Ju.numpy(), np.asarray(jJu), rtol=1e-10, atol=atol)
    # and the oracle agrees with the forward-mode Jacobians it checks
    _, (aJx, aJu) = env.dynamics_derivatives(torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(Jx.numpy(), aJx.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Ju.numpy(), aJu.numpy(), rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(2)
    lo, hi = env.action_space.low.astype(np.float64), env.action_space.high.astype(np.float64)
    us = lo + (hi - lo) * rng.uniform(0.3, 0.7, size=(3, 4, env.nu))
    xs = env.rollout(torch.as_tensor(x), torch.as_tensor(us))
    assert xs.shape == (3, 5, env.nx)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jenv.rollout(jnp.asarray(x),
                                                                   jnp.asarray(us))), **TOL)


# -- solvers ------------------------------------------------------------------------

def test_kkt_residuals_match_jax():
    env, jenv = make_env("rexquadrotor"), jax_make_env("rexquadrotor")
    nx, nu, T, bsz = env.nx, env.nu, 5, 4
    rng = np.random.default_rng(3)
    x = 0.3 * rng.normal(size=(bsz, T, nx))
    u = env.u_hover + 4 * rng.uniform(-1, 1, size=(bsz, T, nu))  # some through the box
    x0 = x[:, 0] + 0.1 * rng.normal(size=(bsz, nx))
    Q = np.abs(rng.normal(size=(bsz, T, nx + nu))) + 0.1
    q = rng.normal(size=(bsz, T, nx + nu))
    lo, hi = env.action_space.low, env.action_space.high

    def jdyn_jac(a, b):
        xn, (Jx, Ju) = jenv.dynamics_derivatives(a, b)
        return xn, jnp.concatenate([Jx, Ju], axis=-1)

    def dyn_jac(a, b):
        xn, (Jx, Ju) = env.dynamics_derivatives(a, b)
        return xn, torch.cat([Jx, Ju], dim=-1)

    jctrl = JaxALMPC(nx, nu, T, lo, hi, jenv.dynamics, jdyn_jac, dtype=jnp.float64,
                     tridiag_backend="xla")
    ctrl = ALMPC(nx, nu, T, lo, hi, env.dynamics, dyn_jac, dtype=torch.float64, device="cpu")
    jr, jc = jctrl.kkt_residuals(jnp.asarray(x0), JaxQuadCost(jnp.asarray(Q), jnp.asarray(q),
                                                              None),
                                 jnp.asarray(x), jnp.asarray(u))
    r, c = ctrl.kkt_residuals(torch.as_tensor(x0), QuadCost(torch.as_tensor(Q),
                                                            torch.as_tensor(q), None),
                              torch.as_tensor(x), torch.as_tensor(u))
    assert r.shape == c.shape == (bsz,) and (r.numpy() > 0).all()
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-8, atol=1e-8)


def test_get_traj_and_get_cost_match_jax():
    env, jenv = make_env("pendulum"), jax_make_env("pendulum")
    bsz, T, nx, nu = 3, 6, env.nx, env.nu
    rng = np.random.default_rng(4)
    u = rng.normal(size=(bsz, T, nu))
    x_init = rng.normal(size=(bsz, nx))
    F = 0.5 * rng.normal(size=(bsz, T - 1, nx, nx + nu))
    f = rng.normal(size=(bsz, T - 1, nx))
    Q = np.abs(rng.normal(size=(bsz, T, nx + nu)))
    q = rng.normal(size=(bsz, T, nx + nu))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    for dyn, jdyn in ((LinDx(t(F), t(f)), JaxLinDx(jnp.asarray(F), jnp.asarray(f))),
                      (env.dynamics, jenv.dynamics)):
        xs = get_traj(T, t(u), t(x_init), dyn)
        jxs = jax_util.get_traj(T, jnp.asarray(u), jnp.asarray(x_init), jdyn)
        assert xs.shape == (bsz, T, nx)
        np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), **TOL)
        c = get_cost(T, t(u), QuadCost(t(Q), t(q), None), dyn, x_init=t(x_init))
        jc = jax_util.get_cost(T, jnp.asarray(u), JaxQuadCost(jnp.asarray(Q), jnp.asarray(q),
                                                              None),
                               jdyn, x_init=jnp.asarray(x_init))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    c = get_cost(T, t(u), QuadCost(t(Q), t(q), None), x=xs)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)


class _WrongGrad(torch.autograd.Function):
    """sum(sin(x) x^2) with the planted gradient cos(x) x^2 (the product
    rule's second term dropped)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sum(torch.sin(x) * x**2)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.cos(x) * x**2


def test_check_fd_grads_passes_a_smooth_function_and_raises_on_a_wrong_gradient():
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(3, 2)))
    g, g_fd = check_fd_grads(lambda v: torch.sum(torch.sin(v) * v**2), x)
    np.testing.assert_allclose(g.numpy(), (torch.cos(x) * x**2 + 2 * x * torch.sin(x)).numpy(),
                               rtol=1e-12)
    jg, jg_fd = jax_util.check_fd_grads(lambda v: jnp.sum(jnp.sin(v) * v**2), jnp.asarray(x))
    np.testing.assert_allclose(g_fd.numpy(), np.asarray(jg_fd), **TOL)
    with pytest.raises(AssertionError):
        check_fd_grads(_WrongGrad.apply, x)


# -- utils --------------------------------------------------------------------------

def test_merge_args_matches_jax():
    live = argparse.Namespace(env="pendulum", T=5, eval=True, seed=3)
    saved = argparse.Namespace(env="rexquadrotor", T=10, hdim=256)
    a, b = utils.merge_args(live, saved), jax_utils.merge_args(live, saved)
    assert type(a) is type(b) is argparse.Namespace and vars(a) == vars(b)
    assert vars(a) == {"env": "rexquadrotor", "T": 10, "eval": True, "seed": 3, "hdim": 256}
    assert vars(live)["env"] == "pendulum"  # the inputs are not touched


def test_phase_timer_matches_jax(monkeypatch):
    """The same phases on the same (faked) clock give the same summary."""
    out = []
    for mod in (profiling, jax_profiling):
        ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.5, 3.0, 3.75])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        timer = mod.PhaseTimer()
        for name in ("fwd", "bwd", "fwd", "bwd"):
            with timer.phase(name, sync=None):
                pass
        out.append((timer.summary(), timer.report()))
    monkeypatch.undo()
    assert out[0] == out[1] == ({"fwd": 0.5, "bwd": 0.5}, "bwd=500.0ms  fwd=500.0ms")
    timer = profiling.PhaseTimer()  # a CPU tensor to sync on: no device sync
    with timer.phase("x", sync={"a": [torch.zeros(2)]}):
        pass
    assert set(timer.summary()) == {"x"} and not profiling._holds_cuda({"a": [torch.zeros(2)]})


def test_profile_step_keys_match_jax():
    argv = ["--env", "pendulum", "--T", "3", "--deq_iter", "1", "--hdim", "8", "--bsz", "2",
            "--n_rep", "1"]
    out = profile_step.main([*argv, "--device", "cpu"])
    ref = jax_profile_step.main(argv)
    assert set(out) == set(ref)
    assert {k: out[k] for k in ("env", "T", "bsz", "hdim")} == {k: ref[k] for k in
                                                                ("env", "T", "bsz", "hdim")}
    assert all(np.isfinite(v) for k, v in out.items() if k.endswith("_ms"))
    assert out["train_step_ms"] > 0


# -- the eval's start window and parameter sensitivity ---------------------------------

def test_rexquad_reset_takes_a_start_window():
    env = make_env("rexquadrotor")
    w = np.array([0.5, 0.4, 0.3] + [np.deg2rad(10)] * 3 + [0.2] * 6)
    x = env.reset(torch.Generator().manual_seed(0), 256, device="cpu", dtype=torch.float64,
                  x_window=w)
    # the same draws in Euler space, from the same seed
    lo = env._uniform(torch.Generator().manual_seed(0), 256, -w, w)
    assert (lo.abs() <= torch.as_tensor(w)).all()
    np.testing.assert_array_equal(x[:, :3].numpy(), lo[:, :3].numpy())
    np.testing.assert_array_equal(x[:, 6:].numpy(), lo[:, 6:].numpy())
    np.testing.assert_allclose(x[:, 3:6].numpy(),
                               quat2mrp(euler_to_quaternion(lo[:, 3:6])).numpy(), rtol=0,
                               atol=0)
    assert (x[:, :3].abs().amax(0).numpy() <= w[:3]).all()
    # the default window is wider
    wide = env.reset(torch.Generator().manual_seed(0), 256, device="cpu", dtype=torch.float64)
    assert float(wide[:, :3].abs().max()) > w[:3].max()


def test_eval_x_window_keeps_rexquad_starts_inside_and_is_refused_without_it():
    args = {"env": "rexquadrotor", "T": 5, "hdim": 8, "deq_iter": 1, "nq": 6,
            "eval_x_window": "0.3,0.3,0.3,0.1,0.1,0.1,0.2,0.2,0.2,0.2,0.2,0.2"}
    env = make_env("rexquadrotor")
    pol = build_policy(args, env, "cpu").init(0)
    seen = []
    real_forward = pol.forward

    def forward(x, **kw):
        seen.append(x.clone())
        return real_forward(x, **kw)

    pol.forward = forward
    out = port_eval.eval_policy(args, env, pol, n_episodes=8, ep_len=1, device="cpu")
    assert out["n_nan_episodes"] == 0
    assert (seen[0][:, :3].abs() <= 0.3).all() and (seen[0][:, 6:].abs() <= 0.2).all()
    # an env whose reset takes no window: refused in both packages
    penv, jpenv = make_env("pendulum"), jax_make_env("pendulum")
    ppol = build_policy({**args, "env": "pendulum", "nq": 1}, penv, "cpu")
    with pytest.raises(ValueError, match="eval_x_window"):
        port_eval.eval_policy({**args, "env": "pendulum"}, penv, ppol, n_episodes=2, ep_len=1,
                              device="cpu")
    jargs = types.SimpleNamespace(env="pendulum", eval_x_window="0.1,0.1", streaming=False,
                                  qp_solve=True, lastqp_solve=False)
    with pytest.raises(ValueError, match="eval_x_window"):
        jax_eval.eval_policy(jargs, jpenv, None, None, n_episodes=2, ep_len=1)


def test_check_param_sensitivity_matches_jax():
    """The base loss and the loss of one perturbed parameter set, made in
    numpy and given to both packages (hdim 32, N 2, f64)."""
    env, jpol, params, pol = pair("base", seed=8)
    batch = {k: np.asarray(v, np.float64) for k, v in pendulum_batch(1).items()}
    jargs = types.SimpleNamespace(qp_solve=True, lastqp_solve=False)
    args = {"qp_solve": True, "lastqp_solve": False}
    res = port_eval.check_param_sensitivity(args, env, pol, batch, scales=(0.01, 0.1), seed=0)
    ref = jax_eval.check_param_sensitivity(jargs, env, jpol, params, batch, scales=())
    np.testing.assert_allclose(res["base_loss"], ref["base_loss"], rtol=1e-9)
    assert set(res) == {"base_loss", "loss_at_0.01", "loss_at_0.1"}
    assert all(np.isfinite(v) for v in res.values()) and res["loss_at_0.1"] != res["base_loss"]
    # one perturbed set, from numpy, into both
    rng = np.random.default_rng(9)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    noisy = jax.tree_util.tree_unflatten(treedef, [
        leaf + 0.03 * jnp.std(leaf) * jnp.asarray(rng.normal(size=leaf.shape))
        for leaf in leaves])
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, noisy))
    got = port_eval.param_set_loss(args, pol, batch, state)
    want = jax_eval.check_param_sensitivity(jargs, env, jpol, noisy, batch, scales=())
    np.testing.assert_allclose(got, want["base_loss"], rtol=1e-9)
    assert abs(got - res["base_loss"]) > 1e-6
    # the policy's own parameters are back in place
    np.testing.assert_allclose(port_eval.param_set_loss(args, pol, batch), res["base_loss"],
                               rtol=1e-14)
    # the sets are the generator's: the same seed, the same losses
    again = port_eval.check_param_sensitivity(args, env, pol, batch, scales=(0.01, 0.1), seed=0)
    assert again == res
