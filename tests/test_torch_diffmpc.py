"""Every model type, the port against the JAX package in f64: the policy
loop's switches (`qp_solve`, `lastqp_solve`) through `NNMPCPolicy` with a
final solve, diff-mpc-deq, the deq and nn model types and a flying-cartpole
diff-mpc-deq forward with obstacle rows (hdim 32, trajectories and status
within 1e-7); a diff-mpc-deq training step and a `--pretrain` step (loss
and every parameter gradient, rtol 1e-9, atol 1e-9 x the tensor's largest
entry); `apply_model_type_presets` for the six types (exact); `NNPolicy`
with its four output types (1e-10); and tick 0 of the two committed
diff-mpc checkpoints at full width (4 states, first actions within the f64
tick-0 limits of PERF.md: median <= 1e-4, 75th percentile <= 1e-3). A
planted fault, the final solve cut to 2 AL iterations, fails the forward
check. Then the train and eval CLIs of the new types on the CPU."""
import argparse
import dataclasses
import functools
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deqmpc_tpu.envs import make_env as jax_make_env  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import DEQMPCPolicy as JaxPolicy  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import NNMPCPolicy as JaxNNMPCPolicy  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import PolicyConfig as JaxPolicyConfig  # noqa: E402
from deqmpc_tpu.policies.nn_policy import NNPolicy as JaxNNPolicy  # noqa: E402
from deqmpc_tpu.solvers import ObstacleSet as JaxObstacleSet  # noqa: E402
from deqmpc_tpu.training import train as jax_train  # noqa: E402
from deqmpc_tpu_torch import data as port_data  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.models import FFDNetwork  # noqa: E402
from deqmpc_tpu_torch.policies import (DEQMPCPolicy, NNMPCPolicy, NNPolicy,  # noqa: E402
                                       PolicyConfig, build_policy)
from deqmpc_tpu_torch.solvers import ObstacleSet  # noqa: E402
from deqmpc_tpu_torch.training import eval as port_eval  # noqa: E402
from deqmpc_tpu_torch.training import train  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint, params_from_jax  # noqa: E402
from test_torch_cartpole_flying_policy import _jit_pieces  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
POLICY_TOL = dict(rtol=1e-7, atol=1e-7)
# the final solve's trajectory and duals (10 AL iterations, rho up to 1e5):
# per sample within 1e-5, or within 10x JAX's own move under a 1e-14
# relative move of the start states (printed with -s). That move reaches
# 2.5e-3 on the controls of an nnmpc_lastqp sample whose line search ties
# (the port is 4.3e-3 from JAX there)
FINAL_SOLVE_TOL = dict(rtol=1e-5, atol=1e-5)
SENSITIVITY_FACTOR = 10.0
HDIM, BSZ = 32, 4
# name: (env, T, nq, policy class, deq_type, deq_iter, qp_solve, lastqp_solve, radius)
CASES = {
    "nnmpc_lastqp": ("pendulum", 5, 1, "nnmpc", "nn", 1, False, True, None),
    "diff_mpc_deq": ("pendulum", 5, 1, "deqmpc", "deq", 1, False, True, None),
    "deq": ("pendulum", 5, 1, "deqmpc", "deq", 1, False, False, None),
    "nn": ("pendulum", 5, 1, "nnmpc", "nn", 1, False, False, None),
    "flying_diff_mpc_obstacles": ("FlyingCartpole_obstacles", 5, 7, "deqmpc", "deq", 1, False,
                                  True, 0.25),
}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), **tol, err_msg=msg)


def _policies(case, seed):
    """The JAX policy with perturbed f64 parameters and the port's policy
    loaded with them, with the case's switches in the port's config."""
    env_name, T, nq, kind, deq_type, deq_iter, qp, lastqp, radius = CASES[case]
    env = make_env(env_name)
    jobs = tobs = None
    if radius is not None:
        jobs = JaxObstacleSet(jnp.asarray(env.obstacle_positions), radius)
        tobs = ObstacleSet(torch.as_tensor(env.obstacle_positions), radius)
    kw = dict(nx=env.nx, nu=env.nu, nq=nq, T=T, dt=env.dt, hdim=HDIM, deq_iter=deq_iter,
              rho_max=1e5, deq_type=deq_type)
    jcls, cls = (JaxNNMPCPolicy, NNMPCPolicy) if kind == "nnmpc" else (JaxPolicy, DEQMPCPolicy)
    jpol = jcls(JaxPolicyConfig(**kw, solver_dtype=jnp.float64), jax_make_env(env_name),
                obstacles=jobs)
    params = jpol.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64) + 0.05 * rng.normal(size=a.shape)),
        params)
    pol = cls(PolicyConfig(**kw, solver_dtype=torch.float64, qp_solve=qp, lastqp_solve=lastqp),
              env, device="cpu", obstacles=tobs)
    pol.model.double()
    pol.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return env, jpol, params, pol


def _start_states(env, n, seed, near_obstacles=False):
    obs = env.reset(torch.Generator().manual_seed(seed), n, device="cpu", dtype=torch.float64)
    if near_obstacles:  # start beside a sphere: the first knots' rows are active
        obs[:, :3] = torch.as_tensor(env.obstacle_positions[:n]) + 0.1
    return obs


@functools.lru_cache(maxsize=None)
def _reference(case):
    """JAX's forward of the case (the network call and the NewtonAL solve
    jitted apart), once per case, and once more from start states moved
    by 1e-14 (relative)."""
    _, _, _, _, _, _, qp, lastqp, radius = CASES[case]
    env, jpol, params, _ = _policies(case, seed=7)
    obs = _start_states(env, BSZ, 1, near_obstacles=radius is not None)
    fwd = functools.partial(_jit_pieces(jpol).forward, qp_solve=qp, lastqp_solve=lastqp)
    moved = obs.numpy() * (1 + 1e-14 * np.random.default_rng(0).normal(size=obs.shape))
    return obs, fwd(params, jnp.asarray(obs.numpy())), fwd(params, jnp.asarray(moved))


def _per_sample(a):
    return np.abs(_np(a)).reshape(len(a), -1).max(axis=1)


def _close_per_sample(got, ref, moved, tol, msg, scale=1.0):
    """Per sample, |got - ref| - rtol |ref| within atol * scale, or within
    SENSITIVITY_FACTOR x JAX's own move (`moved` - `ref`); at most one
    sample may take the second limit."""
    got, ref, moved = _np(got), _np(ref), _np(moved)
    err = (np.abs(got - ref) - tol["rtol"] * np.abs(ref)).reshape(len(ref), -1).max(axis=1)
    sens = SENSITIVITY_FACTOR * _per_sample(moved - ref)
    limit = np.maximum(tol["atol"] * scale, sens)
    print(f"{msg}: per sample, port vs JAX {_per_sample(got - ref)}, "
          f"JAX's own move {_per_sample(moved - ref)}")
    assert (err <= limit).all(), f"{msg}: per-sample error {err} beyond {limit}"
    assert (sens <= tol["atol"] * scale).sum() >= len(ref) - 1, f"{msg}: sensitivity {sens}"


def _check_forward(case, pol=None):
    obs, (ref, ref_carry), (moved, moved_carry) = _reference(case)
    if pol is None:
        _, _, _, pol = _policies(case, seed=7)
    with torch.inference_mode():
        out = pol.forward(obs)
    assert len(out["trajs"]) == len(ref["trajs"]) == 1
    (x_ref, x, u), (rx_ref, rx, ru), (_, mx, mu) = out["trajs"][0], ref["trajs"][0], moved[
        "trajs"][0]
    _close(x_ref, rx_ref, POLICY_TOL, "x_ref")
    np.testing.assert_array_equal(_np(out["status"]), np.asarray(ref["status"]))
    _close(out["carry"].x, ref_carry.x, POLICY_TOL, "carry x")
    if not pol.cfg.lastqp_solve:
        _close(x, rx, POLICY_TOL, "x")
        _close(u, ru, POLICY_TOL, "u")
        _close(out["carry"].solver.lam, ref_carry.solver.lam, POLICY_TOL, "lam")
        return pol, out
    _close_per_sample(x, rx, mx, FINAL_SOLVE_TOL, "x")
    _close_per_sample(u, ru, mu, FINAL_SOLVE_TOL, "u")
    _close_per_sample(out["carry"].solver.lam, ref_carry.solver.lam, moved_carry.solver.lam,
                      FINAL_SOLVE_TOL, "lam", scale=float(np.max(ref_carry.solver.rho)))
    return pol, out


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    pol, out = _check_forward(case)
    lastqp = CASES[case][7]
    assert isinstance(pol.model, FFDNetwork) == (CASES[case][4] == "nn")
    x_ref, x, u = out["trajs"][0]
    if lastqp:
        # the final solve of 10 AL iterations moved the trajectory off the
        # network's reference and set the penalty
        assert pol.newton_steps > 10 and float((x - x_ref).abs().max()) > 1e-3
        assert float(out["carry"].solver.rho.min()) > 1.0
    else:
        # no solve: the network's own trajectory, and the network's zeros
        assert pol.newton_steps == 0 and torch.equal(x, x_ref) and not u.any()
    if case == "flying_diff_mpc_obstacles":
        off = pol.T * pol.nx + 2 * pol.nu * pol.T
        assert np.abs(_np(out["carry"].solver.lam)[:, off:]).max() > 1e-3


def test_planted_fault_short_final_solve_fails_the_forward_check():
    _, _, _, pol = _policies("diff_mpc_deq", seed=7)

    class ShortFinalSolve(type(pol.tracking_mpc)):
        def __call__(self, *a, al_iters=2, **kw):
            return super().__call__(*a, al_iters=min(al_iters, 2), **kw)

    pol.tracking_mpc.__class__ = ShortFinalSolve
    with pytest.raises(AssertionError):
        _check_forward("diff_mpc_deq", pol)


# -- training steps --------------------------------------------------------------

def _batch(env_name, T):
    env = make_env(env_name)
    gt, _ = train.split_episodes(port_data.get_gt_data(env)[:40])
    batch = port_data.sample_trajectory(gt, BSZ, 1, T, np.random.default_rng(11))
    return train.preprocess_batch(env_name, env.nx, batch)


STEP_CASES = {  # name: (policy case, pretrain)
    "diff_mpc_deq": ("diff_mpc_deq", False),
    "pretrain": ("pretrain", True),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_train_step_loss_and_gradients_match_jax(name, monkeypatch):
    case, pretrain = STEP_CASES[name]
    if pretrain:  # deq-mpc-deq, 2 rounds, whose first phase runs no solve
        monkeypatch.setitem(CASES, "pretrain",
                            ("pendulum", 5, 1, "deqmpc", "deq", 2, True, False, None))
    env, jpol, params, pol = _policies(case, seed=5)
    qp, lastqp = CASES[case][6:8]
    batch = _batch("pendulum", pol.T)
    opt = optax.chain(optax.clip_by_global_norm(2.0), optax.adam(1e-3))
    _, loss_fn = jax_train.make_train_step(
        jpol, opt, types.SimpleNamespace(qp_solve=qp, lastqp_solve=lastqp), pretrain=pretrain)
    jbatch = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in batch.items()}
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, aux), grads = step(params, jbatch, jnp.ones((pol.deq_iter, 3)))
    # JAX's own move under a 1e-14 relative move of the batch's start states
    moved = {**jbatch, "obs": jbatch["obs"] * (1 + 1e-14 * np.random.default_rng(0).normal(
        size=jbatch["obs"].shape))}
    (loss_m, aux_m), _ = step(params, moved, jnp.ones((pol.deq_iter, 3)))
    loss_port = train.make_loss_fn(pretrain=pretrain)
    d = loss_port(pol, train.to_device(batch, "cpu", torch.float64))
    d["loss"].backward()
    # a diff-mpc step backpropagates through its final solve only
    assert pol.backward_solves == (0 if pretrain else 1)
    # the losses within rtol 1e-9, or within SENSITIVITY_FACTOR x JAX's own
    # move (printed with -s): through the final solve that move is 1.9e-9
    # (relative) on loss_end, past the port's gap of 1.1e-9
    for key, got_l, ref_l, ref_m in (("loss", d["loss"], loss, loss_m),
                                     ("loss_end", d["loss_end"], aux["loss_end"],
                                      aux_m["loss_end"])):
        gap, own = (abs(float(got_l) - float(ref_l)) / abs(float(ref_l)),
                    abs(float(ref_m) - float(ref_l)) / abs(float(ref_l)))
        print(f"{name} {key}: port vs JAX {gap:.3g}, JAX's own move {own:.3g}")
        assert gap <= max(1e-9, SENSITIVITY_FACTOR * own), (key, gap, own)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    got = dict(pol.model.named_parameters())
    assert set(ref) == set(got)
    for pname, g_ref in ref.items():
        if pname == "iter_emb":  # unused by the forward: JAX zeros, no torch grad
            assert got[pname].grad is None and not g_ref.numpy().any()
            continue
        tol = dict(rtol=1e-9, atol=1e-9 * float(g_ref.abs().max()))
        _close(got[pname].grad, g_ref, tol, pname)
    assert np.abs(_np(got["out.Conv_1.kernel"].grad)).max() > 1e-4


def _jax_params_from_port(tree, state):
    """The port's state dict carried into the JAX parameter tree `tree`
    (`params_from_jax` backwards: Dense kernels transposed back)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path if k == "params" else path + [k]) for k, v in node.items()}
        if len(path) >= 2 and path[-2].startswith("Dense_") and path[-1] == "kernel":
            arr = state[".".join(path[:-1] + ["weight"])].numpy().T
        else:
            arr = state[".".join(path)].numpy()
        assert arr.shape == np.shape(node), path
        return jnp.asarray(arr)

    return walk(tree, [])


def test_diffmpc_step_gradient_at_rho_max_jumps_in_jax_too():
    """The diff-mpc step of `tests/test_torch_train_cuda.py` (pendulum,
    hdim 32, the port's seeded weights, rho_max 1e5, its batch of 8) in
    JAX and in the port, f64. At the batch the port's loss and gradient are
    JAX's within 1e-9. Under 1e-14 relative moves of the start states
    JAX's own gradient moves by at least JAX_GRADIENT_JUMP (a control of
    the final solve on its box bound within rounding: whether its row
    enters the backward's Hessian is rounding), and every gradient the
    port reaches under the same moves is one that JAX reaches, within
    1e-8. The card's gradient gap at this step is held against this jump
    there. Prints the moves."""
    from test_torch_train_cuda import JAX_GRADIENT_JUMP, _diffmpc_pair, _diffmpc_step_batch

    env, pols = _diffmpc_pair(seed=1, devices=("cpu",))
    pol = pols["cpu"]
    kw = {k: getattr(pol.cfg, k) for k in ("nx", "nu", "nq", "T", "dt", "hdim", "deq_iter",
                                           "rho_max")}
    jpol = JaxPolicy(JaxPolicyConfig(**kw, solver_dtype=jnp.float64), jax_make_env("pendulum"))
    params = _jax_params_from_port(jpol.init(jax.random.PRNGKey(0)), pol.model.state_dict())
    _, loss_fn = jax_train.make_train_step(
        jpol, optax.adam(1e-3), types.SimpleNamespace(qp_solve=False, lastqp_solve=True))
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    names = sorted(n for n, _ in pol.model.named_parameters() if n != "iter_emb")

    def jax_step(b):
        (loss, _), g = step(params, {k: jnp.asarray(v, jnp.float64) for k, v in b.items()},
                            jnp.ones((1, 3)))
        g = params_from_jax(jax.tree_util.tree_map(np.asarray, g))
        return float(loss), np.concatenate([g[n].numpy().ravel() for n in names])

    def port_step(b):
        pol.model.zero_grad(set_to_none=True)
        d = train.loss_fn(pol, train.to_device(b, "cpu", torch.float64))
        d["loss"].backward()
        grads = {n: p.grad.detach().numpy() for n, p in pol.model.named_parameters()
                 if p.grad is not None}
        return float(d["loss"]), np.concatenate([grads[n].ravel() for n in names])

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    batch = _diffmpc_step_batch()
    (loss, g), (loss_port, g_port) = jax_step(batch), port_step(batch)
    assert abs(loss_port - loss) <= 1e-9 * abs(loss) and rel(g_port, g) <= 1e-9
    jax_grads, port_grads = [g], []
    for seed in range(8):
        moved = {**batch, "obs": batch["obs"] * (1 + 1e-14 * np.random.default_rng(seed).normal(
            size=batch["obs"].shape))}
        jax_grads.append(jax_step(moved)[1])
        port_grads.append(port_step(moved)[1])
    jumps = [rel(a, g) for a in jax_grads[1:]]
    reached = [min(rel(a, b) for b in jax_grads) for a in port_grads]
    print(f"JAX's own gradient moves {jumps}; the port's gradients, each from the nearest "
          f"of JAX's {reached}")
    assert max(jumps) >= JAX_GRADIENT_JUMP
    assert max(reached) <= 1e-8


# -- presets and the plain policy --------------------------------------------------

@pytest.mark.parametrize("model_type", train.MODEL_TYPES)
def test_model_type_presets_match_jax(model_type):
    args = train.parse_args(["--model_type", model_type, "--deq_iter", "6"])
    ref = jax_train.apply_model_type_presets(jax_train.build_argparser().parse_args(
        ["--model_type", model_type, "--deq_iter", "6"]))
    for key in ("deq", "qp_solve", "lastqp_solve", "deq_iter", "deq_type"):
        assert getattr(args, key) == getattr(ref, key), key
    got = train.apply_model_type_presets(argparse.Namespace(model_type=model_type, deq_iter=6,
                                                            deq_type="deq"))
    assert vars(got) == {k: getattr(ref, k) for k in vars(got)}


@pytest.mark.parametrize("out_type", [0, 1, 2, 3])
def test_nn_policy_matches_jax(out_type):
    jpol = JaxNNPolicy(nx=2, nu=1, nq=1, T=5, dt=0.05, hdim=16, out_type=out_type)
    rng = np.random.default_rng(out_type)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64) + 0.1 * rng.normal(size=a.shape)),
        jpol.init(jax.random.PRNGKey(out_type)))
    x = rng.normal(size=(4, 2))
    ref = jpol(params, jnp.asarray(x))
    pol = NNPolicy(nx=2, nu=1, nq=1, T=5, dt=0.05, hdim=16, out_type=out_type, device="cpu")
    pol.net.double()
    pol.net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    got = pol(torch.as_tensor(x))
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            _close(g, r, dict(rtol=1e-10, atol=1e-10))
    fresh = NNPolicy(nx=2, nu=1, nq=1, T=5, dt=0.05, hdim=16, out_type=out_type,
                     device="cpu").init(0)
    assert all(torch.isfinite(v).all() for v in fresh.net.state_dict().values())


# -- the committed diff-mpc checkpoints at full width --------------------------------

@pytest.mark.parametrize("ckpt", ["pendulum_diffmpc_deq", "flying_diffmpc_deq"])
def test_checkpoint_first_actions_match_jax_in_f64(ckpt):
    """One network call and the final 10-iteration solve at hdim 256,
    loaded by each package's own reader; JAX jits the network call and the
    NewtonAL solve alone."""
    path = REPO / "checkpoints" / ckpt
    state, args = load_checkpoint(path, "cpu")
    env = make_env(args["env"])
    cfg = build_policy(args, env, "cpu").cfg
    assert (cfg.hdim, cfg.deq_iter, cfg.T, cfg.qp_solve, cfg.lastqp_solve, cfg.solver_type) == (
        256, 1, 5, False, True, "al")
    pol = DEQMPCPolicy(dataclasses.replace(cfg, solver_dtype=torch.float64), env, device="cpu")
    pol.model.double()
    pol.model.load_state_dict(state)
    jpol = JaxPolicy(JaxPolicyConfig(nx=env.nx, nu=env.nu, nq=cfg.nq, T=cfg.T, dt=env.dt,
                                     hdim=cfg.hdim, deq_iter=cfg.deq_iter, rho_max=cfg.rho_max,
                                     solver_dtype=jnp.float64), jax_make_env(args["env"]))
    params, _, _, _ = jax_train.load_checkpoint(str(path), jpol.init(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    _jit_pieces(jpol)
    obs = _start_states(env, 4, 2)
    ref, _ = jpol.forward(params, jnp.asarray(obs.numpy()), qp_solve=False, lastqp_solve=True)
    with torch.inference_mode():
        u = _np(pol.forward(obs)["trajs"][-1][2][:, 0])
    gap = np.abs(u - np.asarray(ref["trajs"][-1][2][:, 0])).max(axis=-1)
    assert np.isfinite(u).all()
    assert np.median(gap) <= 1e-4 and np.quantile(gap, 0.75) <= 1e-3, gap


# -- the CLIs on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--model_type", "diff-mpc-deq"],
    ["--model_type", "diff-mpc-nn"],
    ["--model_type", "deq"],
    ["--model_type", "nn"],
    ["--model_type", "deq-mpc-deq", "--deq_iter", "2", "--pretrain"],
    ["--model_type", "deq-mpc-deq", "--deq_iter", "2", "--solver_type", "ip", "--qp_iter", "2",
     "--eps", "1e-3", "--ip_grad_method", "finite_diff"],
])
def test_train_cli_takes_every_model_type_and_the_ip_solver(argv, tmp_path):
    res = train.main(["--env", "pendulum", "--T", "5", "--hdim", "16", "--bsz", "4",
                      "--max_train_steps", "2", "--val_every", "1", "--device", "cpu",
                      "--save", "--name", "run", "--models_dir", str(tmp_path),
                      "--logdir", str(tmp_path / "logs"), *argv])
    assert len(res["curve"]) == 2 and all(np.isfinite(r["val_loss_end"]) for r in res["curve"])
    assert res["curve"][0]["pretrain"] == ("--pretrain" in argv)
    out = port_eval.main(["--ckpt", str(tmp_path / "run"), "--episodes", "2", "--ep_len", "2",
                          "--device", "cpu"])
    assert out["n_nan_episodes"] == 0 and out["model_type"] == argv[1]
    assert out["solver_type"] == ("ip" if "ip" in argv else "al")


def test_build_policy_serves_both_diff_mpc_checkpoints_and_the_ip_override():
    for ckpt in ("pendulum_diffmpc_deq", "flying_diffmpc_deq"):
        state, args = load_checkpoint(REPO / "checkpoints" / ckpt, "cpu")
        pol = build_policy(args, make_env(args["env"]), "cpu")
        pol.model.load_state_dict(state)
        assert isinstance(pol, DEQMPCPolicy) and pol.deq_iter == 1
    pol = build_policy({**args, "deq": False}, make_env(args["env"]), "cpu")
    assert isinstance(pol, NNMPCPolicy) and isinstance(pol.model, FFDNetwork)
    res = port_eval.main(["--ckpt", str(REPO / "checkpoints" / "pendulum_deqmpc"), "--episodes",
                          "2", "--ep_len", "1", "--device", "cpu", "--solver_type", "ip"])
    assert res["solver_type"] == "ip" and res["n_nan_episodes"] == 0
