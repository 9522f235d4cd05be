"""The cartpole and flying-cartpole envs of the port against the JAX
package: dynamics and Jacobians in f64 (1e-10), the state clip, reward,
bad-state test and obstacle field (exact or to rounding), the eval's
final-state errors and success dims, the expert data of configs #2, #3 and
#3b, and the train and eval CLIs on these envs on the CPU."""
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.data import datagen as jax_datagen  # noqa: E402
from deqmpc_tpu.envs import make_env as jax_make_env  # noqa: E402
from deqmpc_tpu.training import eval as jax_eval  # noqa: E402
from deqmpc_tpu.training import train as jax_train  # noqa: E402
from deqmpc_tpu_torch import data as port_data  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.training import eval as port_eval  # noqa: E402
from deqmpc_tpu_torch.training import train  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-10, atol=1e-10)
NAMES = ["cartpole1link", "cartpole2link", "flyingcartpole", "flyingcartpole_obstacles"]


def _inputs(env, lead, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (env.nx,))
    u = 1.2 * env.action_space.high * rng.uniform(-1, 1, size=lead + (env.nu,))
    return x, u


@pytest.mark.parametrize("name", NAMES[:3])
@pytest.mark.parametrize("lead", [(7,), (3, 4)])
def test_dynamics_and_derivatives_match_jax(name, lead):
    jenv, tenv = jax_make_env(name), make_env(name)
    x, u = _inputs(tenv, lead, seed=len(lead))
    y_ref = np.asarray(jenv.dynamics(jnp.asarray(x), jnp.asarray(u)))
    np.testing.assert_allclose(tenv.dynamics(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
                               y_ref, **TOL)
    xn_ref, (Jx_ref, Ju_ref) = jenv.dynamics_derivatives(jnp.asarray(x), jnp.asarray(u))
    with torch.inference_mode():
        xn, (Jx, Ju) = tenv.dynamics_derivatives(torch.as_tensor(x), torch.as_tensor(u))
    assert Jx.shape == lead + (tenv.nx, tenv.nx) and Ju.shape == lead + (tenv.nx, tenv.nu)
    for a, b in ((xn, xn_ref), (Jx, Jx_ref), (Ju, Ju_ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert np.abs(Ju.numpy()).max() > 1e-3  # the control reaches the state


@pytest.mark.parametrize("name", NAMES[:3])
def test_f32_jacobians_stay_f32(name):
    env = make_env(name)
    x, u = (torch.as_tensor(a, dtype=torch.float32) for a in _inputs(env, (5,), seed=3))
    with torch.inference_mode():
        xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
    assert xn.dtype == Jx.dtype == Ju.dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_constants_match_jax(name):
    jenv, tenv = jax_make_env(name), make_env(name)
    for k in ("nx", "nu", "nq", "dt", "spec_id", "_max_episode_steps"):
        assert getattr(tenv, k) == getattr(jenv, k), k
    for k in ("Qlqr", "Rlqr", "targ_pos"):
        np.testing.assert_array_equal(getattr(tenv, k), getattr(jenv, k), err_msg=k)
    np.testing.assert_array_equal(tenv.action_space.low, jenv.action_space.low)
    np.testing.assert_array_equal(tenv.action_space.high, jenv.action_space.high)


def test_obstacle_field_is_jax_exactly():
    for name in ("flyingcartpole_obstacles", "flyingcartpole_obstacles_dense"):
        jenv, tenv = jax_make_env(name), make_env(name)
        np.testing.assert_array_equal(tenv.obstacle_positions, jenv.obstacle_positions)
        assert tenv.obstacle_radius == jenv.obstacle_radius
        assert tenv.spec_id == jenv.spec_id
    assert make_env("flyingcartpole_obstacles").obstacle_positions.shape == (40, 3)


@pytest.mark.parametrize("name", NAMES)
def test_step_clip_reward_and_bad_states_match_jax(name):
    jenv, tenv = jax_make_env(name), make_env(name)
    x, u = _inputs(tenv, (9,), seed=4)
    x[:, 1:3] *= 8.0  # angles far outside [0, 2 pi) for the clip
    x[0, 0] = 11.0 if "flying" not in name else x[0, 0]  # the cartpole's px > 10 term
    if "obstacles" in name:
        x[1, :3] = tenv.obstacle_positions[3] + 0.05  # inside a sphere
    xj, rj = jenv.step(jnp.asarray(x), jnp.asarray(u))
    xt, rt = tenv.step(torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)
    np.testing.assert_array_equal(tenv.state_clip(torch.as_tensor(x)).numpy(),
                                  np.asarray(jenv.state_clip(jnp.asarray(x))))
    np.testing.assert_allclose(tenv.reward(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
                               np.asarray(jenv.reward(jnp.asarray(x), jnp.asarray(u))), **TOL)
    x[2, 3] = np.nan
    r = np.array(jenv.reward(jnp.asarray(x), jnp.asarray(u)))
    bad = tenv.is_bad_state(torch.as_tensor(x), torch.as_tensor(r)).numpy()
    np.testing.assert_array_equal(bad, np.asarray(jenv.is_bad_state(jnp.asarray(x),
                                                                     jnp.asarray(r))))
    assert bad[2] and bad[1] == ("obstacles" in name)


@pytest.mark.parametrize("name", NAMES)
def test_reset_is_seeded_and_in_range(name):
    env = make_env(name)
    a = env.reset(torch.Generator().manual_seed(3), 64, device="cpu")
    b = env.reset(torch.Generator().manual_seed(3), 64, device="cpu")
    assert a.shape == (64, env.nx) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    if name.startswith("cartpole"):
        assert (a[:, 0].abs() <= 1.0).all() and (a[:, env.nq:].abs() <= 0.5).all()
        assert ((a[:, 1:env.nq] >= 0) & (a[:, 1:env.nq] < 2 * np.pi)).all()
    else:
        assert (a[:, :3].abs() <= 5.0).all() and (a[:, 7:].abs() <= 1.0).all()
        assert ((a[:, 6] >= 0) & (a[:, 6] <= 2 * np.pi)).all()
        w = np.full(14, 0.1)
        c = env.reset(torch.Generator().manual_seed(3), 64, device="cpu", x_window=w)
        assert (c[:, :3].abs() <= 0.1).all() and ((c[:, 6] - np.pi).abs() <= 0.1).all()


# -- the eval's final-state errors and success dims --------------------------------

@pytest.mark.parametrize("env_name,nx,nq", [("cartpole1link", 4, 2), ("cartpole2link", 6, 3),
                                            ("FlyingCartpole", 14, 7),
                                            ("FlyingCartpole_obstacles", 14, 7),
                                            ("pendulum", 2, 1), ("rexquadrotor", 12, 6)])
def test_final_state_errors_and_success_dims_match_jax(env_name, nx, nq):
    rng = np.random.default_rng(nx)
    x = rng.uniform(-1, 7, size=(16, nx))
    targ = make_env(env_name).targ_pos
    x[:4] = targ + 2 * np.pi - 1e-3  # angles one turn away from the target
    got = port_eval.final_state_errors(x, targ, env_name, nx)
    ref = jax_eval.final_state_errors(x, targ, env_name, nx)
    np.testing.assert_array_equal(got, ref)
    idxs = train.utils.angle_idxs_for_env(env_name, nx)
    if idxs is not None:  # the angle dims are wrapped to [-pi, pi]
        assert (np.abs(got[:, idxs]) <= np.pi).all() and (np.abs(got[:4, idxs]) < 0.01).all()
    assert port_eval.success_dims_for_env(env_name, nx, nq) == \
        jax_eval.success_dims_for_env(env_name, nx, nq)
    assert port_eval.success_dims_for_env("FlyingCartpole", 14, 7) == [0, 1, 2, 6]


# -- expert data ------------------------------------------------------------------------

@pytest.mark.parametrize("name,teacher,spec", [
    ("cartpole1link", "sac", "Cartpole1l-v0"), ("flyingcartpole", "mpc", "FlyingCartpole-v0"),
    ("flyingcartpole_obstacles", "mpc", "FlyingCartpole-v1-obsr0.25")])
def test_expert_data_reads_as_pickle_does(name, teacher, spec):
    env = make_env(name)
    path = port_data.expert_data_path(env.spec_id, teacher)
    assert path.name == f"expert_traj_{teacher}-{spec}_new.pkl"
    got = port_data.get_gt_data(env, teacher)[:20]
    with open(path, "rb") as f:
        ref = pickle.load(f)[:20]
    assert len(got) == len(ref) == 20
    for ep, ep_ref in zip(got, ref):
        for (s, a), (s_ref, a_ref) in zip(ep, ep_ref):
            np.testing.assert_array_equal(s, s_ref)
            np.testing.assert_array_equal(a, a_ref)
            assert s.shape == (env.nx,) and a.shape == (env.nu,)


@pytest.mark.parametrize("env_name,name", [("cartpole1link", "cartpole1link"),
                                           ("FlyingCartpole", "flyingcartpole")])
def test_sample_and_preprocess_match_jax(env_name, name):
    env = make_env(name)
    gt = port_data.merge_gt_data(port_data.get_gt_data(env, "mpc")[:30])
    got = port_data.sample_trajectory(gt, 32, 1, 7, np.random.default_rng(2))
    ref = jax_datagen.sample_trajectory(gt, 32, 1, 7, np.random.default_rng(2))
    got = train.preprocess_batch(env_name, env.nx, got)
    ref = jax_train.preprocess_batch(env_name, env.nx, ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# -- the CLIs on the CPU ------------------------------------------------------------

def test_train_cli_runs_deq_mpc_nn_and_the_sac_teacher_on_cpu():
    res = train.main(["--env", "FlyingCartpole", "--model_type", "deq-mpc-nn", "--nq", "7",
                      "--T", "5", "--deq_iter", "2", "--hdim", "16", "--bsz", "4",
                      "--max_train_steps", "1", "--val_every", "1", "--device", "cpu"])
    assert np.isfinite(res["curve"][0]["loss_end"]) and res["curve"][0]["grad_norm"] > 0
    res = train.main(["--env", "cartpole1link", "--nq", "2", "--T", "10", "--deq_iter", "2",
                      "--hdim", "16", "--bsz", "4", "--teacher", "sac", "--max_train_steps", "1",
                      "--val_every", "1", "--device", "cpu"])
    assert np.isfinite(res["curve"][0]["val_loss_end"])
    args = train.parse_args(["--model_type", "deq-mpc-nn"])
    assert args.deq_type == "nn" and args.teacher == "mpc"
    args = train.parse_args(["--model_type", "diff-mpc-nn"])
    assert (args.deq_type, args.deq_iter, args.qp_solve, args.lastqp_solve) == ("nn", 1, False,
                                                                               True)


def test_build_obstacles_is_the_env_field():
    assert train.build_obstacles(make_env("flyingcartpole")) is None
    env = make_env("flyingcartpole_obstacles")
    obs = train.build_obstacles(env)
    np.testing.assert_array_equal(obs.centers.numpy(), env.obstacle_positions)
    assert obs.radius == 0.25


def test_eval_cli_on_flying_obstacles_reports_collisions():
    res = port_eval.main(["--ckpt", str(REPO / "checkpoints" / "flying_obstacles"), "--episodes", "2",
                          "--ep_len", "2", "--device", "cpu"])
    assert res["n_nan_episodes"] == 0 and 0.0 <= res["collision_rate"] <= 1.0
    assert res["ep_len"] == 2


def test_build_policy_takes_deq_mpc_nn_and_gates_the_obstacle_rows():
    from deqmpc_tpu_torch.models import FFDNetwork
    from deqmpc_tpu_torch.policies import build_policy
    from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint

    _, args = load_checkpoint(REPO / "checkpoints" / "flying_obstacles", "cpu")
    assert "obstacle_constraints" not in args  # a missing key means true
    env = make_env(args["env"])
    obs = train.build_obstacles(env)
    pol = build_policy(args, env, "cpu", obstacles=obs)
    assert isinstance(pol.model, FFDNetwork)
    ctrl = pol.tracking_mpc.ctrl
    assert ctrl.n_obs_sel == 4 and ctrl.ncon == 5 * 14 + 2 * 4 * 5 + 4 * 5
    bare = build_policy({**args, "obstacle_constraints": False}, env, "cpu", obstacles=obs)
    assert bare.tracking_mpc.ctrl.obstacles is None and bare.tracking_mpc.ctrl.ncon == 110
    # Qscale is the env's: the policy builds, the env's velocity weights scale
    from deqmpc_tpu_torch.envs import make_env_of

    scaled = make_env_of({**args, "Qscale": 2.0})
    build_policy({**args, "Qscale": 2.0}, scaled, "cpu", obstacles=obs)
    np.testing.assert_array_equal(scaled.Qlqr[7:], 2.0 * env.Qlqr[7:])
    # the obstacle-aware input: 16 more input channels, the field in the network
    aware = build_policy({**args, "obstacle_net_input": True}, env, "cpu", obstacles=obs)
    assert aware.model.input.Conv_0.kernel.shape[1] == pol.model.input.Conv_0.kernel.shape[1] + 16
    assert aware.model.obstacle_centers.shape == (40, 3)
