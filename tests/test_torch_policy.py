"""The slice as a whole: the port's DEQ-MPC policy forward against the JAX
package in f64, the closed-loop eval on the CPU, and the port's
independence from JAX."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.envs import PendulumEnv as JaxPendulum  # noqa: E402
from deqmpc_tpu.envs import RexQuadrotor as JaxQuad  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import DEQMPCPolicy as JaxPolicy  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import PolicyConfig as JaxPolicyConfig  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.ops import block_tridiag as bt  # noqa: E402
from deqmpc_tpu_torch.policies import DEQMPCPolicy, PolicyConfig, build_policy  # noqa: E402
from deqmpc_tpu_torch.training import eval as port_eval  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint, params_from_jax  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints" / "rexquad_deqmpc"
PENDULUM_CKPT = REPO / "checkpoints" / "pendulum_deqmpc"
JAX_ENVS = {"pendulum": JaxPendulum, "rexquadrotor": JaxQuad}


def _perturbed_params(policy, seed):
    params = policy.init(jax.random.PRNGKey(seed))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(leaf + 0.05 * rng.normal(size=leaf.shape), np.float32)
              for leaf in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("env_name", ["pendulum", "rexquadrotor"])
def test_policy_forward_matches_jax_in_f64(env_name):
    env = make_env(env_name)
    nq = 1 if env_name == "pendulum" else 6
    kw = dict(nx=env.nx, nu=env.nu, nq=nq, T=5, dt=env.dt, hdim=32, deq_iter=2, rho_max=1e5)
    jpol = JaxPolicy(JaxPolicyConfig(**kw, solver_dtype=jnp.float64), JAX_ENVS[env_name]())
    params = _perturbed_params(jpol, seed=env.nx)
    obs = env.reset(torch.Generator().manual_seed(1), 4, device="cpu", dtype=torch.float64)
    out_ref, _ = jax.jit(jpol.forward)(params, jnp.asarray(obs.numpy()))

    pol = DEQMPCPolicy(PolicyConfig(**kw, solver_dtype=torch.float64), env, device="cpu")
    pol.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    pol.model.double()
    with torch.inference_mode():
        out = pol.forward(obs)
    assert len(out["trajs"]) == len(out_ref["trajs"]) == 2
    for i, (got, ref) in enumerate(zip(out["trajs"], out_ref["trajs"])):
        for name, a, b in zip(("x_ref", "x", "u"), got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7, atol=1e-7,
                                       err_msg=f"round {i} {name}")
    np.testing.assert_array_equal(out["status"].numpy(), np.asarray(out_ref["status"]))
    assert pol.newton_steps > 0


def test_eval_policy_two_ticks_on_cpu():
    state, args = load_checkpoint(CKPT, "cpu")
    env = make_env(args["env"])
    policy = build_policy(args, env, "cpu")
    policy.model.load_state_dict(state)
    before = bt.block_tridiag_solve.launches
    res = port_eval.eval_policy(args, env, policy, n_episodes=2, ep_len=2, seed=0,
                                device="cpu")
    assert res["n_nan_episodes"] == 0 and np.isfinite(res["mean_reward"])
    assert 0.0 <= res["success_rate"] <= 1.0 and res["final_dist_mean"] > 0
    assert bt.block_tridiag_solve.launches == before  # the CPU runs the plain solve
    assert policy.newton_steps > 0


def test_pendulum_checkpoint_first_actions_match_jax_in_f64():
    """`pendulum_deqmpc` at full width (hdim 256, N 6), loaded by each
    package's own reader, tick 0 of 4 seeded start states in f64: the
    first actions agree within the f64 tick-0 tolerance of PERF.md
    (median <= 1e-4, 75th percentile <= 1e-3 of the per-state gap)."""
    from deqmpc_tpu.training.train import load_checkpoint as jax_load_checkpoint

    state, args = load_checkpoint(PENDULUM_CKPT, "cpu")
    env = make_env(args["env"])
    pol = build_policy(args, env, "cpu")
    cfg = pol.cfg
    assert (cfg.hdim, cfg.deq_iter, cfg.T) == (256, 6, 5)
    pol = DEQMPCPolicy(dataclasses.replace(cfg, solver_dtype=torch.float64), env, device="cpu")
    pol.model.double()
    pol.model.load_state_dict(state)
    jpol = JaxPolicy(JaxPolicyConfig(nx=env.nx, nu=env.nu, nq=cfg.nq, T=cfg.T, dt=env.dt,
                                     hdim=cfg.hdim, deq_iter=cfg.deq_iter, rho_max=cfg.rho_max,
                                     solver_dtype=jnp.float64), JaxPendulum())
    params, _, _, _ = jax_load_checkpoint(str(PENDULUM_CKPT), jpol.init(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    obs = env.reset(torch.Generator().manual_seed(2), 4, device="cpu", dtype=torch.float64)
    out_ref, _ = jax.jit(jpol.forward)(params, jnp.asarray(obs.numpy()))
    with torch.inference_mode():
        u = pol.forward(obs)["trajs"][-1][2][:, 0].numpy()
    gap = np.abs(u - np.asarray(out_ref["trajs"][-1][2][:, 0])).max(axis=-1)
    assert np.isfinite(u).all()
    assert np.median(gap) <= 1e-4 and np.quantile(gap, 0.75) <= 1e-3, gap


def test_eval_cli_on_pendulum_reports_the_mean_and_its_error(tmp_path):
    out = tmp_path / "eval.json"
    res = port_eval.main(["--ckpt", str(PENDULUM_CKPT), "--episodes", "2", "--ep_len", "3",
                          "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == res
    assert {"mean_reward", "final_dist_mean", "final_dist_median", "final_dist_sem",
            "success_rate", "n_nan_episodes", "tick_s_median", "ckpt", "episodes", "ep_len",
            "seed", "device", "wall_s"} <= set(res)
    assert res["n_nan_episodes"] == 0 and res["ep_len"] == 3
    assert np.isfinite(res["final_dist_sem"]) and res["final_dist_sem"] >= 0


def test_success_dims_and_errors():
    assert port_eval.success_dims_for_env("rexquadrotor", 12, 6) == [0, 1, 2]
    assert port_eval.success_dims_for_env("pendulum", 2, 1) == [0]
    err = port_eval.final_state_errors(np.array([[2 * np.pi - 0.1, 0.0]]),
                                       np.array([0.0, 0.0]), "pendulum")
    np.testing.assert_allclose(err, [[-0.1, 0.0]], atol=1e-12)


def test_entry_points_raise_without_a_card_when_no_device_is_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, args = load_checkpoint(CKPT, "cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        build_policy(args, make_env("rexquadrotor"))
    with pytest.raises(RuntimeError, match="is_available"):
        port_eval.main(["--ckpt", str(CKPT), "--episodes", "1", "--ep_len", "1"])


def test_build_policy_refuses_what_is_not_ported():
    """Every value the JAX CLI takes builds; a deq_type it does not take is
    refused."""
    _, args = load_checkpoint(CKPT, "cpu")
    assert build_policy({**args, "fp_type": "broyden"}, make_env("rexquadrotor"),
                        "cpu").model.cfg.fp_type == "broyden"
    with pytest.raises(NotImplementedError, match="deq_type"):
        build_policy({**args, "deq_type": "gcn"}, make_env("rexquadrotor"), "cpu")


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, imported in a fresh
    interpreter, leaves JAX, flax, msgpack and the JAX package unimported."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in (REPO / "deqmpc_tpu_torch").rglob("*.py"))
    assert {"deqmpc_tpu_torch.ops.block_tridiag", "deqmpc_tpu_torch.solvers.pdipm",
            "deqmpc_tpu_torch.solvers.ip_mpc", "deqmpc_tpu_torch.policies.nn_policy",
            "deqmpc_tpu_torch.models.deq_layer_variants", "deqmpc_tpu_torch.models.grad_layers",
            "deqmpc_tpu_torch.policies.policy_variants"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'deqmpc_tpu')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
