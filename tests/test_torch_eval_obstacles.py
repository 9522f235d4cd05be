"""The obstacle protocol (`deqmpc_tpu_torch/eval_obstacles.py`) against JAX's
`scripts/eval_obstacles.py` on the CPU: `wilson_ci`, `rollout_stats` (the
constrained arm with the obstacle-aware network) and
`rollout_safety_filter` (the blind policy behind a T_f 10 filter) on
`FlyingCartpole_obstacles_dense` at hdim 32 and N 2, 4 episodes x 3 ticks
from the same patched start states (two beside a sphere), and the CLI's
arms.

Both policies carry JAX's initial weights in f64 and run their solves in
f64 (rho_max 1e5); both packages cast the observation to f32 first.
Tolerances: `wilson_ci` exactly; the collision masks and counts equal;
the final states at 1e-6 for `rollout_stats`: each tick rounds the state
to f32 before the forward (as JAX does), and where the two packages' f64
states differ in their last bits the rounding can land on neighbouring
f32 values (6e-8 relative), which the f64 solve carries into the next
state (measured: 7.1e-8 after 3 ticks). The filter's `TrackingMPC` is pinned to
f32 in both packages, so its final states are held within 10x the move
of JAX's own final states under a 1e-6 move of the starts, and at least
1e-5.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.envs import make_env as jax_make_env  # noqa: E402
from deqmpc_tpu.solvers import ObstacleSet as JaxObstacleSet  # noqa: E402
from deqmpc_tpu.training import train as jax_train  # noqa: E402
from deqmpc_tpu_torch import eval_obstacles  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.policies import build_policy  # noqa: E402
from deqmpc_tpu_torch.training.train import build_obstacles  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import params_from_jax  # noqa: E402

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "jax_eval_obstacles", Path(__file__).resolve().parents[1] / "scripts" / "eval_obstacles.py")
jax_eo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_eo)

ENV = "FlyingCartpole_obstacles_dense"
N_EP, TICKS = 4, 3


def _args(aware):
    a = jax_train.build_argparser().parse_args(
        f"--env {ENV} --model_type deq-mpc-nn --T 5 --deq_iter 2 --hdim 32 --nq 7 "
        "--dtype double --rho_max 1e5".split())
    a = jax_train.apply_model_type_presets(a)
    a.obstacle_net_input = aware
    return a


def _pair(aware, obstacles):
    """The JAX policy and f64 params, and the port's policy with them."""
    jenv, env = jax_make_env(ENV), make_env(ENV)
    args = _args(aware)
    jobs = JaxObstacleSet(centers=jnp.asarray(jenv.obstacle_positions),
                          radius=float(jenv.obstacle_radius)) if obstacles else None
    jpol = jax_train.build_policy(args, jenv, obstacles=jobs)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                                    jpol.init(jax.random.PRNGKey(0)))
    pol = build_policy(vars(args), env, "cpu",
                       obstacles=build_obstacles(env) if obstacles else None)
    pol.model.double()
    pol.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jenv, jpol, params, env, pol


def _starts(env, move=0.0):
    rng = np.random.default_rng(0)
    x0 = np.zeros((N_EP, 14))
    x0[:, :3] = rng.uniform(-2, 2, (N_EP, 3))
    x0[:, 6] = np.pi + rng.uniform(-0.2, 0.2, N_EP)
    x0[:2, :3] = env.obstacle_positions[:2] + [0.45, 0.0, 0.0]  # just outside two spheres
    x0[:2, 7] = -2.0  # flying at them
    return x0 + move


def _patch(monkeypatch, env, jenv, x0):
    monkeypatch.setattr(env, "reset", lambda g, n, device="cpu", dtype=torch.float64:
                        torch.as_tensor(x0, dtype=dtype, device=device))
    monkeypatch.setattr(jenv, "reset", lambda rng, n: jnp.asarray(x0))


def test_wilson_ci_matches_jax():
    for k, n in ((0, 0), (0, 10), (155, 512), (138, 512), (512, 512), (3, 7)):
        assert eval_obstacles.wilson_ci(k, n) == jax_eo.wilson_ci(k, n)


def _record(monkeypatch, env, jenv):
    """Each package's last stepped states and its episodes' collision masks,
    recorded per run: the port's env methods wrapped, JAX's where the
    script jits them."""
    rec = {}

    def port(name, fn):
        def wrapped(*a):
            r = fn(*a)
            rec[f"port_{name}"] = (r[0] if name == "step" else r).detach().numpy().copy()
            if name == "collide":
                rec["port_mask"] = rec.get("port_mask", False) | rec["port_collide"]
            return r
        return wrapped

    monkeypatch.setattr(env, "step", port("step", env.step))
    monkeypatch.setattr(env, "check_collisions", port("collide", env.check_collisions))
    real_jit = jax.jit

    def jit(fn, *a, **kw):
        j = real_jit(fn, *a, **kw)
        for name, method in (("step", jenv.step), ("collide", jenv.check_collisions)):
            if fn == method:
                def wrapped(*args, j=j, name=name):
                    r = j(*args)
                    rec[f"jax_{name}"] = np.asarray(r[0] if name == "step" else r)
                    if name == "collide":
                        rec["jax_mask"] = rec.get("jax_mask", False) | rec["jax_collide"]
                    return r
                return wrapped
        return j

    monkeypatch.setattr(jax, "jit", jit)
    return rec


def test_rollout_stats_matches_jax(monkeypatch):
    jenv, jpol, params, env, pol = _pair(aware=True, obstacles=True)
    _patch(monkeypatch, env, jenv, _starts(env))
    rec = _record(monkeypatch, env, jenv)
    res = eval_obstacles.rollout_stats(env, pol, N_EP, TICKS)
    jres = jax_eo.rollout_stats(jenv, jpol, params, N_EP, TICKS)
    for k in ("collision_rate", "collision_ci95", "success_rate", "success_ci95", "n_nan",
              "n_episodes"):
        assert res[k] == jres[k], k
    np.testing.assert_array_equal(rec["port_mask"], rec["jax_mask"])
    assert rec["port_mask"].any()
    np.testing.assert_allclose(rec["port_step"], rec["jax_step"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res["final_dist_mean"], jres["final_dist_mean"], rtol=1e-6)


@pytest.mark.slow
def test_rollout_safety_filter_matches_jax(monkeypatch):
    """Slow: JAX compiles the filter's tick anew in each of its two runs."""
    jenv, jpol, params, env, pol = _pair(aware=False, obstacles=False)
    rec = _record(monkeypatch, env, jenv)
    _patch(monkeypatch, env, jenv, _starts(env))
    res = eval_obstacles.rollout_safety_filter(env, pol, N_EP, TICKS, T_f=10)
    jres = jax_eo.rollout_safety_filter(jenv, jpol, params, N_EP, TICKS, T_f=10)
    x_jax, mask_jax = rec["jax_step"], rec.pop("jax_mask")
    for k in ("collision_rate", "collision_ci95", "n_nan", "filter_T", "n_episodes"):
        assert res[k] == jres[k], k
    np.testing.assert_array_equal(rec["port_mask"], mask_jax)
    # JAX's own move under a 1e-6 move of the starts
    _patch(monkeypatch, env, jenv, _starts(env, 1e-6))
    jax_eo.rollout_safety_filter(jenv, jpol, params, N_EP, TICKS, T_f=10)
    own = np.abs(rec["jax_step"] - x_jax).max()
    gap = np.abs(rec["port_step"] - x_jax).max()
    assert gap <= max(10 * own, 1e-5), (gap, own)


def test_cli_runs_the_arms(monkeypatch, tmp_path):
    """`main` builds each arm's policy from its checkpoint and hands it to
    the rollouts: constrained and unconstrained from --ckpt_obs (the same
    weights, the rows on and off), plain and filter from --ckpt_plain."""
    from deqmpc_tpu_torch.utils.checkpoint import save_checkpoint

    env = make_env(ENV)
    seen = []
    monkeypatch.setattr(eval_obstacles, "rollout_stats", lambda e, p, **kw: seen.append(
        ("stats", p.cfg.obstacle_net_input, p.cfg.obstacle_constraints,
         p.tracking_mpc.ctrl.ncon)) or {"n": kw["n"]})
    monkeypatch.setattr(eval_obstacles, "rollout_safety_filter", lambda e, p, T_f, **kw:
                        seen.append(("filter", T_f, p.cfg.obstacle_net_input)) or {"T_f": T_f})
    for name, aware in (("obs", True), ("plain", False)):
        pol = build_policy({**vars(_args(aware)), "hdim": 256, "deq_iter": 6, "dtype": "float32",
                            "rho_max": None}, env, "cpu",
                           obstacles=build_obstacles(env) if aware else None)
        save_checkpoint(tmp_path / name, pol.model, step=7)
    out = eval_obstacles.main(["--ckpt_obs", str(tmp_path / "obs"), "--ckpt_plain",
                               str(tmp_path / "plain"), "--obstacle_net_input", "--env", ENV,
                               "--arms", "constrained,unconstrained,plain,filter",
                               "--safety_filter_T", "10", "--episodes", "3", "--cpu",
                               "--out", str(tmp_path / "r.json")])
    assert set(out) == {"constrained", "unconstrained_same_weights", "plain_policy",
                        "safety_filter"}
    assert out["constrained"]["ckpt_step"] == 7 and out["safety_filter"]["ckpt_step"] == 7
    kinds = [s[:3] for s in seen]
    assert kinds == [("stats", True, True), ("stats", True, False), ("stats", False, True),
                     ("filter", 10, False)]
    assert (tmp_path / "r.json").exists()
