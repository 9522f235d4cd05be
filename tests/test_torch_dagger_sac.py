"""Slice 10's RL teacher and DAgger round, the port against the JAX package
on the CPU: `training/sac.py` (the featurizer, `squash`, the networks with
weights carried across, one update, the replay ring, `generate_expert`,
the `--save_actor` pickle) and `data/dagger.py` (the envelope filter,
`collect_policy_states`, `corrective_episodes`, the `shards` phase and the
`all` orchestration).

Everything runs in f64. Both packages' networks get the same parameters
(JAX's initialisation, carried across in flax's layout), and where a JAX
function draws inside, the port is given JAX's draw (`squash`'s noise) or
both envs' `reset` is patched to hand out the same numpy states.
Tolerances:
- the featurizer, the ring's indices and wrap, and the envelope filter
  exactly; `squash` and `unsquash_det` at 1e-12; the actor and critic
  forwards at 1e-12;
- one `_update` on a fixed batch with JAX's noise: the critic and actor
  losses, alpha, the new log-alpha and every new parameter of the actor,
  critic and target, after one Adam step each, at 1e-10;
- `generate_expert` from patched starts at noise 0 at 1e-10;
- the DAgger round on the pendulum policy (hdim 32, N 2, perturbed f64
  weights): the visited states and the kept starts at 1e-9 (the policy's
  forward through two rounds of NewtonAL), the energy teacher's corrective
  episodes and the appended pickle at 1e-10.
No test writes under `data/`.
"""
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.data import dagger as jax_dagger  # noqa: E402
from deqmpc_tpu.envs import make_env as jax_make_env  # noqa: E402
from deqmpc_tpu.training import sac as jax_sac  # noqa: E402
from deqmpc_tpu_torch.data import dagger, datagen, expert_gen  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.training import sac  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import dense_stack_from_jax, dense_stack_to_jax  # noqa: E402
from torch_variant_pairs import pair  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-10)
FWD_TOL = dict(rtol=1e-12, atol=1e-12)
HDIM, BATCH = 32, 16


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def sac_pair():
    """JAX's trainer and f64 state (its own init carried to f64), and the
    port's trainer and a state with the same networks."""
    jenv, env = jax_make_env("pendulum"), make_env("pendulum")
    jtr = jax_sac.SACTrainer(jenv, "pendulum", n_envs=4, hdim=HDIM, buffer_size=64,
                             batch=BATCH, start_steps=8, ep_len=20)
    js = jtr.init(0)
    actor, critic = _f64(js.actor), _f64(js.critic)
    js = js._replace(actor=actor, critic=critic, target=critic,
                     opt_actor=jtr.opt_a.init(actor), opt_critic=jtr.opt_c.init(critic),
                     log_alpha=jnp.asarray(0.0, jnp.float64),
                     opt_alpha=jtr.opt_t.init(jnp.asarray(0.0, jnp.float64)))
    tr = sac.SACTrainer(env, "pendulum", n_envs=4, hdim=HDIM, buffer_size=64, batch=BATCH,
                        start_steps=8, ep_len=20, device="cpu", dtype=torch.float64)
    pa = sac.TanhGaussianActor(tr.nobs_dim, tr.nu, HDIM).double()
    pa.load_state_dict(dense_stack_from_jax(_np(actor)))
    pc = sac.DoubleCritic(tr.nobs_dim, tr.nu, HDIM).double()
    pc.load_state_dict(dense_stack_from_jax(_np(critic)))
    st = tr.state_from(pa, pc, torch.Generator().manual_seed(0))
    return jtr, js, tr, st


@pytest.mark.parametrize("name", ["pendulum", "cartpole2link", "rexquadrotor", "FlyingCartpole"])
def test_obs_featurizer_matches_jax(name):
    env = make_env(name)
    feat, dim = sac.obs_featurizer(name, env.nx)
    jfeat, jdim = jax_sac.obs_featurizer(name, env.nx)
    assert dim == jdim
    x = np.random.default_rng(0).normal(size=(5, env.nx)) * 4
    np.testing.assert_array_equal(feat(torch.as_tensor(x)).numpy(), np.asarray(jfeat(x)))


def test_squash_and_unsquash_match_jax():
    rng = np.random.default_rng(1)
    mu, ls = rng.normal(size=(7, 4)) * 3, rng.uniform(-5, 2, size=(7, 4))
    lo, hi = np.full(4, -1.5, np.float32), np.full(4, 2.5, np.float32)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, mu.shape))
    a, logp = sac.squash(*map(torch.as_tensor, (mu, ls, eps, lo, hi)))
    ja, jlogp = jax_sac.squash(jnp.asarray(mu), jnp.asarray(ls), key, jnp.asarray(lo),
                               jnp.asarray(hi))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **FWD_TOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), **FWD_TOL)
    np.testing.assert_allclose(
        sac.unsquash_det(*map(torch.as_tensor, (mu, lo, hi))).numpy(),
        np.asarray(jax_sac.unsquash_det(jnp.asarray(mu), jnp.asarray(lo), jnp.asarray(hi))),
        **FWD_TOL)


def test_networks_match_jax_and_round_trip(sac_pair):
    jtr, js, tr, st = sac_pair
    obs = np.random.default_rng(2).normal(size=(9, tr.nobs_dim))
    act = np.random.default_rng(3).normal(size=(9, tr.nu))
    mu, ls = st.actor(torch.as_tensor(obs))
    jmu, jls = jtr.actor.apply(js.actor, jnp.asarray(obs))
    q1, q2 = st.critic(torch.as_tensor(obs), torch.as_tensor(act))
    jq1, jq2 = jtr.critic.apply(js.critic, jnp.asarray(obs), jnp.asarray(act))
    for a, b in ((mu, jmu), (ls, jls), (q1, jq1), (q2, jq2)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD_TOL)
    back = dense_stack_to_jax(st.critic.state_dict())
    jtree = _np(js.critic)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jtree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, b)


def test_init_is_flax_lecun_normal():
    """The port's own init: zero biases, weights within 2 std of a std-1/sqrt(fan_in)
    truncated normal, the sample std near it."""
    tr = sac.SACTrainer(make_env("rexquadrotor"), "rexquadrotor", n_envs=2, hdim=256,
                        buffer_size=8, device="cpu")
    st = tr.init(0)
    w = st.critic.layers[1].weight.detach()
    std = (1 / 256) ** 0.5
    assert float(w.abs().max()) <= 2 * std / sac._TRUNC_STD
    assert abs(float(w.std()) / std - 1) < 0.02
    assert all(float(layer.bias.abs().max()) == 0 for layer in st.actor.layers)
    assert st.target is not st.critic
    for t, c in zip(st.target.parameters(), st.critic.parameters()):
        assert torch.equal(t, c) and t.data_ptr() != c.data_ptr()


def test_update_matches_jax(sac_pair):
    jtr, js, tr, _ = sac_pair
    pa = sac.TanhGaussianActor(tr.nobs_dim, tr.nu, HDIM).double()
    pa.load_state_dict(dense_stack_from_jax(_np(js.actor)))
    pc = sac.DoubleCritic(tr.nobs_dim, tr.nu, HDIM).double()
    pc.load_state_dict(dense_stack_from_jax(_np(js.critic)))
    st = tr.state_from(pa, pc, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    batch = (rng.uniform(-3, 3, (BATCH, 2)), rng.uniform(-2, 2, (BATCH, 1)),
             rng.normal(size=BATCH), rng.uniform(-3, 3, (BATCH, 2)),
             (rng.uniform(size=BATCH) < 0.25).astype(np.float64))
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(key, (BATCH, tr.nu)))
    js2, jinfo = jtr._update(js, tuple(map(jnp.asarray, batch)), key)
    st, info = tr._update(st, tuple(map(torch.as_tensor, batch)), torch.as_tensor(eps))
    for k in ("critic_loss", "actor_loss", "alpha"):
        np.testing.assert_allclose(float(info[k]), float(jinfo[k]), **TOL)
    np.testing.assert_allclose(float(st.log_alpha), float(js2.log_alpha), **TOL)
    assert float(st.log_alpha) != 0.0
    for mod, tree in ((st.actor, js2.actor), (st.critic, js2.critic), (st.target, js2.target)):
        ref = dense_stack_from_jax(_np(tree))
        for k, v in mod.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), **TOL, err_msg=k)


def test_replay_write_wraps_as_jax(sac_pair):
    jtr, js, tr, st = sac_pair
    rp, jrp = st.replay, js.replay
    rng = np.random.default_rng(6)
    for _ in range(20):  # 4 lanes into 64 slots: wraps past the end
        obs, nobs = rng.normal(size=(4, 2)), rng.normal(size=(4, 2))
        act, rew, done = rng.normal(size=(4, 1)), rng.normal(size=4), rng.uniform(size=4)
        tr._write(rp, *map(torch.as_tensor, (obs, act, rew, nobs, done)))
        jrp = jtr._write(jrp, *map(jnp.asarray, (obs, act, rew, nobs, done)))
        assert (rp.ptr, rp.size) == (int(jrp.ptr), int(jrp.size))
        for f in ("obs", "act", "rew", "nobs", "done"):
            np.testing.assert_array_equal(getattr(rp, f).numpy(),
                                          np.asarray(getattr(jrp, f), np.float32))
    assert rp.size == 64 and rp.ptr == 16


def test_generate_expert_matches_jax(sac_pair, monkeypatch):
    jtr, js, tr, st = sac_pair
    x0 = np.random.default_rng(7).uniform([0, -1], [2 * np.pi, 1], (5, 2))
    monkeypatch.setattr(tr.env, "reset", lambda g, n, device="cpu", dtype=torch.float64:
                        torch.as_tensor(x0, dtype=dtype))
    monkeypatch.setattr(jtr.env, "reset", lambda rng, n: jnp.asarray(x0))
    eps = tr.generate_expert(st, n_episodes=5, ep_len=30, noise_std=0.0)
    jeps = jtr.generate_expert(js, n_episodes=5, ep_len=30, noise_std=0.0)
    assert len(eps) == len(jeps) == 5
    for ep, jep in zip(eps, jeps):
        for (s, a), (js_, ja) in zip(ep, jep):
            np.testing.assert_allclose(s, js_, **TOL)
            np.testing.assert_allclose(a, ja, **TOL)


def test_run_steps_the_loop(sac_pair):
    """12 iterations past start_steps 8: finite losses, the ring's fill, the
    actions inside the box."""
    _, _, tr, _ = sac_pair
    st = tr.init(1)
    st, info = tr.run(st, 12)
    assert st.step == 12 and st.replay.size == 48 and st.replay.ptr == 48
    for k in ("critic_loss", "actor_loss", "alpha", "rew"):
        assert info[k].shape == (12,) and bool(torch.isfinite(info[k]).all()), k
    act = st.replay.act[:48]
    assert float(act.min()) >= -2.0 and float(act.max()) <= 2.0


def test_save_actor_pickles_read_by_either_package(sac_pair, tmp_path):
    jtr, js, tr, st = sac_pair
    obs = torch.as_tensor(np.random.default_rng(8).normal(size=(3, tr.nobs_dim)))
    port_pkl, jax_pkl = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    sac.save_actor(port_pkl, st.actor)
    with open(port_pkl, "rb") as f:
        tree = pickle.load(f)
    mu, _ = st.actor(obs)
    np.testing.assert_allclose(np.asarray(jtr.actor.apply(tree, jnp.asarray(obs.numpy()))[0]),
                               mu.detach().numpy(), **FWD_TOL)
    with open(jax_pkl, "wb") as f:
        pickle.dump(jax.device_get(js.actor), f)
    actor = sac.load_actor(jax_pkl, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(actor(obs)[0].detach().numpy(),
                               np.asarray(jtr.actor.apply(js.actor, jnp.asarray(obs.numpy()))[0]),
                               **FWD_TOL)


# -- DAgger -------------------------------------------------------------------------------

def test_envelope_filter_matches_jax_on_the_committed_dataset(monkeypatch):
    """`collect_policy_states`' filter on the committed pendulum dataset: the
    same states kept, from visited states patched in (a policy that steps
    the env to given states)."""
    env = make_env("pendulum")
    c, h = dagger.teacher_envelope(env)
    rng = np.random.default_rng(9)
    states = c + 2.0 * h * rng.uniform(-1, 1, (40, 2))
    eps = datagen.load_expert_pickle(datagen.expert_data_path(env.spec_id, "mpc"))
    ds = np.stack([s for ep in eps[:200] for s, _ in ep[::8]])
    lo, hi = np.percentile(ds, 2, axis=0), np.percentile(ds, 98, axis=0)
    jc, jh = (lo + hi) / 2, np.maximum((hi - lo) / 2, 1e-3)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(h, jh)
    keep = np.all(np.abs(states - c) <= 1.5 * h, axis=-1)
    assert 0 < keep.sum() < len(states)


@pytest.fixture(scope="module")
def pendulum_pair():
    env, jpol, params, pol = pair("base", seed=12)
    return env, jpol, params, pol


def _dagger_args(**kw):
    return types.SimpleNamespace(**{"env": "pendulum", "qp_solve": True, "lastqp_solve": False,
                                    "teacher": "mpc", "dagger_horizon": 30, "al_iters": 8, **kw})


def test_dagger_round_on_the_pendulum_matches_jax(pendulum_pair, monkeypatch, tmp_path):
    """One round: collect (2 episodes x 8 ticks from patched starts), the
    energy teacher's corrective episodes from the kept starts, then the
    shards phase in-process appending to a temporary --out."""
    env, jpol, params, pol = pendulum_pair
    jenv = jax_make_env("pendulum")
    x0 = np.array([[np.pi + 0.2, 0.3], [np.pi - 0.4, -0.5]])
    monkeypatch.setattr(env, "reset", lambda g, n, device="cpu", dtype=torch.float64:
                        torch.as_tensor(x0, dtype=dtype))
    monkeypatch.setattr(jenv, "reset", lambda rng, n: jnp.asarray(x0))
    args = _dagger_args()
    states = dagger.collect_policy_states(args, env, pol, n_episodes=2, ep_len=8)
    jstates = jax_dagger.collect_policy_states(args, jenv, jpol, params, n_episodes=2,
                                               ep_len=8)
    assert len(states) == len(jstates) > 0
    np.testing.assert_allclose(states, jstates, rtol=1e-9, atol=1e-9)

    eps = dagger.corrective_episodes(args, env, states, ep_len=6, noise_std=0.0, device="cpu")
    jeps = jax_dagger.corrective_episodes(args, jenv, jstates, ep_len=6, noise_std=0.0)
    assert len(eps) == len(jeps) == len(states)
    for ep, jep in zip(eps, jeps):
        for (s, a), (js_, ja) in zip(ep, jep):
            np.testing.assert_allclose(s, js_, **TOL)
            np.testing.assert_allclose(a, ja, **TOL)

    # the shards phase, its expert_gen subprocesses run in this process
    starts_npz, out = tmp_path / "starts.npz", tmp_path / "pend.pkl"
    np.savez(starts_npz, x0=states)
    calls = []

    def run_in_process(cmd, **kw):
        calls.append(cmd)
        assert cmd[:3] == [sys.executable, "-m", "deqmpc_tpu_torch.data.expert_gen"]
        expert_gen.main(cmd[3:])
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(dagger.subprocess, "run", run_in_process)
    path = dagger.main(["--env", "pendulum", "--phase", "shards", "--starts_npz",
                        str(starts_npz), "--out", str(out), "--dagger_ep_len", "6",
                        "--dagger_noise_std", "0", "--cpu"])
    monkeypatch.undo()  # subprocess.run is the module's own
    assert path == str(out) and len(calls) == 1 and "--append" in calls[0]
    committed = datagen.load_expert_pickle(datagen.expert_data_path("Pendulum-v0", "mpc"))
    written = datagen.load_expert_pickle(out)
    assert len(written) == len(committed) + len(jeps)
    for ep, jep in zip(written[len(committed):], jeps):
        for (s, a), (js_, ja) in zip(ep, jep):
            np.testing.assert_allclose(s, js_, **TOL)
            np.testing.assert_allclose(a, ja, **TOL)
    assert not list(tmp_path.glob("*.shard*"))
    assert subprocess.check_output(["git", "status", "--porcelain", "data"],
                                   cwd=datagen.DATA_DIR.parent, text=True) == ""


def test_dagger_all_runs_collect_then_shards(monkeypatch):
    calls = []
    monkeypatch.setattr(dagger.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or subprocess.CompletedProcess(cmd, 0))
    argv = ["--env", "pendulum", "--phase", "all", "--ckpt", "all", "--cpu"]
    assert dagger.main(argv) is None
    base = [sys.executable, "-m", "deqmpc_tpu_torch.data.dagger", "--env", "pendulum",
            "--ckpt", "all", "--cpu"]
    assert calls == [base + ["--phase", "collect"], base + ["--phase", "shards"]]
    assert dagger.strip_phase(["--phase=all", "--name", "all"]) == ["--name", "all"]
    monkeypatch.setattr(dagger.subprocess, "run",
                        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 3))
    with pytest.raises(SystemExit, match="collect failed"):
        dagger.main(argv)


def test_dagger_collect_phase_writes_the_chosen_starts(monkeypatch, tmp_path):
    """The collect phase from a port checkpoint (the pendulum policy at hdim 32
    saved by the port), 64 x 200 cut to 2 x 8 by patching its defaults."""
    from deqmpc_tpu_torch.utils.checkpoint import save_checkpoint

    env, _, _, pol = pair("base", seed=12)
    pol.model.float()
    save_checkpoint(tmp_path / "pend", pol.model, args={})
    monkeypatch.setattr(dagger, "collect_policy_states",
                        lambda *a, **kw: np.arange(40.0).reshape(20, 2))
    starts = dagger.main(["--env", "pendulum", "--T", "5", "--nq", "1", "--hdim", "32",
                          "--deq_iter", "2", "--models_dir", str(tmp_path), "--ckpt", "pend",
                          "--phase", "collect", "--dagger_episodes", "5", "--starts_npz",
                          str(tmp_path / "s.npz"), "--cpu"])
    np.testing.assert_array_equal(np.load(tmp_path / "s.npz")["x0"], starts)
    assert starts.shape == (5, 2)
    idx = np.random.default_rng(0).choice(20, size=5, replace=False)
    np.testing.assert_array_equal(starts, np.arange(40.0).reshape(20, 2)[idx])


@pytest.mark.slow
def test_dagger_mpc_corrective_episodes_rexquad_match_jax():
    """DAgger's AL-teacher correctives on RexQuadrotor (horizon 30, 8 AL
    iterations, the f32 solve JAX's `corrective_episodes` pins): 2 starts,
    3 ticks. The f32 cast of the state swallows a 1e-14 move, so the port is
    held within 10x JAX's own move under a 1e-6 move of the starts, and 1e-6."""
    rng = np.random.default_rng(10)
    starts = rng.uniform(-0.3, 0.3, (2, 12))
    args = _dagger_args(env="rexquadrotor")
    env, jenv = make_env("rexquadrotor"), jax_make_env("rexquadrotor")
    eps = dagger.corrective_episodes(args, env, starts, ep_len=3, noise_std=0.0, device="cpu")
    jeps = jax_dagger.corrective_episodes(args, jenv, starts, ep_len=3, noise_std=0.0)
    jeps2 = jax_dagger.corrective_episodes(args, jenv, starts + 1e-6, ep_len=3, noise_std=0.0)
    S, A = (np.stack([[v[i] for v in ep] for ep in eps]) for i in (0, 1))
    jS, jA = (np.stack([[v[i] for v in ep] for ep in jeps]) for i in (0, 1))
    jS2, jA2 = (np.stack([[v[i] for v in ep] for ep in jeps2]) for i in (0, 1))
    for a, b, b2 in ((S, jS, jS2), (A, jA, jA2)):
        tol = max(10 * np.abs(b2 - b).max(), 1e-6)
        assert np.abs(a - b).max() <= tol


def test_sac_critic_loss_diverges_on_rexquad_as_in_jax():
    """JAX's SAC reaches an infinite critic loss on RexQuadrotor; the port
    does too and guards nothing: within 40 iterations (8 lanes, hdim 32) both
    critic losses pass 1e12."""
    kw = dict(n_envs=8, hdim=32, buffer_size=1024, batch=32, start_steps=64, ep_len=100)
    jtr = jax_sac.SACTrainer(jax_make_env("rexquadrotor"), "rexquadrotor", **kw)
    _, jinfo = jtr.run(jtr.init(0), 40)
    tr = sac.SACTrainer(make_env("rexquadrotor"), "rexquadrotor", device="cpu", **kw)
    _, info = tr.run(tr.init(0), 40)
    assert float(np.max(np.asarray(jinfo["critic_loss"]))) > 1e12
    assert float(info["critic_loss"].max()) > 1e12
