"""Slice 10's environment pieces, teachers and golden trajectory, the port
against the JAX package on the CPU: `Env.u_trim`, the rotations,
`VecEnv.step`, the four teachers of `data/expert_gen.py`, its CLI, and
`data/golden_traj.py`.

Inputs are made with numpy from a seed and given to both packages; where a
JAX function draws inside (the env resets of `VecEnv`), both envs' `reset`
is patched to hand out the same numpy states. Tolerances:
- `u_trim` exactly; the rotations, `VecEnv.step` (states, rewards,
  `done`, counters), the energy teacher and the flying cascade from
  explicit starts at `noise_std` 0 (states and actions of 40 ticks, and
  which episodes their filters keep) at 1e-10, the same arithmetic;
- the AL teacher (`generate_mpc_expert` in f64: the cartpole from JAX's own
  starts on both sides of the wrap, 6 ticks at horizon 20 with 8 AL
  iterations) and, slow, the capture teacher's rollout in f64 (2 starts, 3
  ticks at horizon 60): recorded states and actions at 1e-7 (the teacher
  casts its actions to f32 as JAX does; measured 1.8e-14). Slow: RexQuadrotor (2
  starts, 3 ticks at horizon 30) and JAX's capture teacher as it is (f32)
  within 10x JAX's own move under a small move of the starts (1e-6 and
  1e-7), and 1e-7: JAX's jitted rollout rounds the f32 action's products
  otherwise than its eager dynamics (1.5e-6 a step on RexQuadrotor), and
  the f32 capture solve at rho 1e8 moves by 0.37 under a 1e-7 move;
- the golden: the port's `rollout_defect` of the committed golden below
  1e-3; its `solve_al` in f64 within JAX's own test's limits (defect 1e-4,
  U 2e-3, X 2e-4); `solve_ip` against JAX's `solve_ip` at 1e-8, at 2 SQP
  iterations and at the default 12, both slow (JAX compiles for 25 s and
  more, 190 s beside tier-1's other workers). Neither package's
  IP solve reproduces the committed golden any more: the line search
  never takes the QP step (a known behaviour, ROADMAP), and the slow test
  holds the port to JAX's own distance from it.
The CLI writes under a temporary `--out`, never under `data/`.
"""
import math
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.data import expert_gen as jax_eg  # noqa: E402
from deqmpc_tpu.data import golden_traj as jax_golden  # noqa: E402
from deqmpc_tpu.envs import make_env as jax_make_env  # noqa: E402
from deqmpc_tpu.envs.vec_env import VecEnv as JaxVecEnv  # noqa: E402
from deqmpc_tpu.utils import rotations as jax_rot  # noqa: E402
from deqmpc_tpu_torch.data import datagen, expert_gen, golden_traj  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.envs.vec_env import VecEnv  # noqa: E402
from deqmpc_tpu_torch.utils import rotations as rot  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-10)
TEACHER_TOL = dict(rtol=1e-7, atol=1e-7)
ENVS = ["pendulum", "cartpole1link", "cartpole2link", "rexquadrotor", "FlyingCartpole",
        "FlyingCartpole_obstacles_dense"]


def _stack(eps):
    return (np.stack([[s for s, _ in ep] for ep in eps]),
            np.stack([[a for _, a in ep] for ep in eps]))


def assert_episodes_close(eps, jeps, tol):
    assert len(eps) == len(jeps)
    if not eps:
        return
    (S, A), (jS, jA) = _stack(eps), _stack(jeps)
    np.testing.assert_allclose(S, jS, **tol)
    np.testing.assert_allclose(A, jA, **tol)


# -- env pieces ------------------------------------------------------------------

@pytest.mark.parametrize("name", ENVS)
def test_u_trim_matches_jax(name):
    assert make_env(name).u_trim == jax_make_env(name).u_trim


def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    p, w = rng.normal(size=(5, 3)) * 0.4, rng.normal(size=(5, 3))
    q1, q2 = rng.normal(size=(4, 4)), rng.normal(size=(4, 4))
    th = rng.uniform(-10, 10, size=7)
    t = torch.as_tensor
    pairs = [(rot.mrp2rot(t(p)), jax_rot.mrp2rot(jnp.asarray(p))),
             (rot._skew(t(w)), jax_rot._skew(jnp.asarray(w))),
             (rot.quat_multiply(t(q1), t(q2)), jax_rot.quat_multiply(jnp.asarray(q1),
                                                                       jnp.asarray(q2))),
             (rot.quat_conj(t(q1)), jax_rot.quat_conj(jnp.asarray(q1))),
             (rot.deg2rad(t(th)), jax_rot.deg2rad(jnp.asarray(th))),
             (rot.angle_normalize(t(th)), jax_rot.angle_normalize(jnp.asarray(th)))]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _patch_resets(monkeypatch, env, jenv, states):
    """Both envs' reset hands out the next of `states` (numpy, one batch per call)."""
    it_port, it_jax = iter(states), iter(states)
    monkeypatch.setattr(env, "reset", lambda g, bsz, device="cpu", dtype=torch.float64:
                        torch.as_tensor(next(it_port), dtype=dtype, device=device))
    monkeypatch.setattr(jenv, "reset", lambda rng, bsz: jnp.asarray(next(it_jax)))


@pytest.mark.parametrize("name", ["pendulum", "rexquadrotor"])
def test_vec_env_step_matches_jax(monkeypatch, name):
    """Steps across the step limit and a planted NaN state: the same states,
    rewards, done flags and counters."""
    env, jenv = make_env(name), jax_make_env(name)
    rng = np.random.default_rng(1)
    n, steps = 5, 7
    resets = [rng.uniform(-1.0, 1.0, size=(n, env.nx)) for _ in range(steps + 1)]
    _patch_resets(monkeypatch, env, jenv, resets)
    vec = VecEnv(env, n_envs=n, max_episode_steps=3, device="cpu", dtype=torch.float64)
    jvec = JaxVecEnv(jenv, n_envs=n, max_episode_steps=3)
    st, jst = vec.reset(torch.Generator()), jvec.reset(jax.random.PRNGKey(0))
    lo, hi = env.action_space.low, env.action_space.high
    saw_done = saw_bad = False
    for k in range(steps):
        u = rng.uniform(lo, hi, size=(n, env.nu))
        if k == 4:  # a bad state: NaN in lane 2
            st = st._replace(x=st.x.clone())
            st.x[2, 0] = float("nan")
            jst = jst._replace(x=jst.x.at[2, 0].set(jnp.nan))
        st, obs, r, done = vec.step(st, torch.as_tensor(u))
        jst, jobs, jr, jdone = jvec.step(jst, jnp.asarray(u))
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), **TOL)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(st.num_steps.numpy(), np.asarray(jst.num_steps))
        saw_done |= bool(done.all())
        saw_bad |= k == 4 and bool(done[2]) and float(r[2]) == 0.0
    assert saw_done and saw_bad


# -- the analytic teachers --------------------------------------------------------

def test_pendulum_energy_teacher_matches_jax():
    rng = np.random.default_rng(2)
    x0 = np.stack([rng.uniform(0, 2 * np.pi, 6), rng.uniform(-2, 2, 6)], axis=-1)
    x0[:2, 0] = np.pi + np.array([0.1, -0.05])  # inside the PD capture window
    eps = expert_gen.generate_pendulum_energy_expert(make_env("pendulum"), ep_len=40, x0=x0,
                                                     noise_std=0.0, device="cpu")
    jeps = jax_eg.generate_pendulum_energy_expert(jax_make_env("pendulum"), ep_len=40, x0=x0,
                                                  noise_std=0.0)
    assert_episodes_close(eps, jeps, TOL)


def _flying_starts(seed, n=6):
    rng = np.random.default_rng(seed)
    x0 = np.zeros((n, 14))
    x0[:, :3] = rng.uniform(-1.5, 1.5, (n, 3))
    x0[:, 3:6] = rng.uniform(-0.1, 0.1, (n, 3))
    x0[:, 6] = np.pi + rng.uniform(-0.4, 0.4, n)
    x0[:, 7:] = rng.uniform(-0.3, 0.3, (n, 7))
    return x0


@pytest.mark.parametrize("name,filt", [("FlyingCartpole", False), ("FlyingCartpole", True),
                                       ("FlyingCartpole_obstacles_dense", False)])
def test_flying_cascade_matches_jax(name, filt):
    """40 ticks of the cascade from explicit starts; with the success filter
    (loosened to keep some of 40-tick episodes) and with the collision filter."""
    x0 = _flying_starts(3)
    env, jenv = make_env(name), jax_make_env(name)
    if "obstacles" in name:  # a start inside a sphere, so the filter drops it
        x0[0, :3] = env.obstacle_positions[0]
    kw = dict(ep_len=40, x0=x0, noise_std=0.0, success_filter=filt, ang_tol=0.5, pos_tol=1.5)
    eps = expert_gen.generate_flying_cartpole_expert(env, device="cpu", **kw)
    jeps = jax_eg.generate_flying_cartpole_expert(jenv, **kw)
    assert 0 < len(jeps) < (len(x0) if filt or "obstacles" in name else len(x0) + 1)
    assert_episodes_close(eps, jeps, TOL)


# -- the AL teacher -----------------------------------------------------------------

def test_mpc_teacher_cartpole_matches_jax():
    """JAX's own starts on both sides of the 2 pi wrap (`test_expert_teachers.py`)."""
    starts = np.zeros((3, 4))
    starts[:, 1] = [0.3, 3.0, 6.0]
    kw = dict(ep_len=6, horizon=20, al_iters=8, x0=starts, env_name="cartpole1link")
    eps = expert_gen.generate_mpc_expert(make_env("cartpole1link"), dtype=torch.float64,
                                         device="cpu", **kw)
    jeps = jax_eg.generate_mpc_expert(jax_make_env("cartpole1link"), dtype=jnp.float64, **kw)
    assert len(eps) == 3
    assert_episodes_close(eps, jeps, TEACHER_TOL)
    S, A = _stack(eps)
    assert S[:, :, 1].min() >= 0.0 and S[:, :, 1].max() < 2 * np.pi
    assert np.abs(A).max() <= make_env("cartpole1link").u_bounds


def test_mpc_teacher_freezes_and_drops_dead_lanes():
    """A lane beyond |x| = 50 is frozen (its state held) and dropped."""
    env = make_env("pendulum_stabilize")
    x0 = np.array([[np.pi, 0.0], [np.pi + 0.1, 0.0], [60.0, 0.0]])
    eps = expert_gen.generate_mpc_expert(env, ep_len=3, horizon=5, al_iters=2, x0=x0,
                                         env_name="pendulum", device="cpu")
    assert len(eps) == 2


def _moved_spread(jeps, jeps_moved, floor):
    """(states, actions) tolerances: 10x JAX's own move between two runs, at
    least `floor`."""
    (S, A), (S2, A2) = _stack(jeps), _stack(jeps_moved)
    return (max(floor, 10 * float(np.abs(S2 - S).max())),
            max(floor, 10 * float(np.abs(A2 - A).max())))


def assert_within(eps, jeps, tols):
    assert len(eps) == len(jeps)
    (S, A), (jS, jA) = _stack(eps), _stack(jeps)
    assert np.abs(S - jS).max() <= tols[0] and np.abs(A - jA).max() <= tols[1], (
        np.abs(S - jS).max(), np.abs(A - jA).max(), tols)


@pytest.mark.slow
def test_mpc_teacher_rexquad_matches_jax():
    """RexQuadrotor, 2 starts, 3 ticks at DAgger's horizon 30, f64 solves.
    JAX's jitted rollout steps the f64 state with f32 actions, and XLA's
    fusion drops some f32 roundings of the action's products that JAX's own
    eager dynamics (and the port's) keep: one step moves the state by 1.5e-6
    (measured, beside 1.4e-17 between the port and eager JAX). So the port is
    held within 10x JAX's own move under a 1e-6 move of the starts, and 1e-7
    (slow: JAX compiles the rollout for a minute a run)."""
    rng = np.random.default_rng(4)
    starts = rng.uniform(-0.5, 0.5, (2, 12))
    kw = dict(ep_len=3, horizon=30, al_iters=8, env_name="rexquadrotor")
    eps = expert_gen.generate_mpc_expert(make_env("rexquadrotor"), dtype=torch.float64,
                                         device="cpu", x0=starts, **kw)
    jenv = jax_make_env("rexquadrotor")
    jeps = jax_eg.generate_mpc_expert(jenv, dtype=jnp.float64, x0=starts, **kw)
    # JAX's jitted step against its own eager dynamics
    S, A = _stack(jeps)
    eager = np.asarray(jenv.dynamics(jnp.asarray(S[:, 0]), jnp.asarray(A[:, 0])))
    assert 1e-7 < np.abs(eager - S[:, 1]).max() < 1e-5
    jeps_moved = jax_eg.generate_mpc_expert(jenv, dtype=jnp.float64, x0=starts + 1e-6, **kw)
    assert len(eps) == 2
    assert_within(eps, jeps, _moved_spread(jeps, jeps_moved, 1e-7))


@pytest.mark.slow
def test_capture_teacher_matches_jax_in_f64():
    """The capture teacher's rollout in f64 (horizon 60, 10 AL iterations,
    the starts its own numpy draw gives, 2 starts, 3 ticks) against JAX's
    `generate_mpc_expert` at the same settings, which its capture teacher
    calls (JAX's capture teacher itself pins f32), at 1e-7 (slow: JAX
    compiles the horizon-60 rollout for two and a half minutes)."""
    x0 = expert_gen.capture_starts(2, seed=0)
    kw = dict(ep_len=3, horizon=60, al_iters=10, noise_std=0.0, x0=x0)
    eps = expert_gen.generate_cartpole2l_capture_expert(make_env("cartpole2link"), tol=100.0,
                                                        dtype=torch.float64, device="cpu", **kw)
    jeps = jax_eg.generate_mpc_expert(jax_make_env("cartpole2link"), env_name="cartpole2link",
                                      dtype=jnp.float64, **kw)
    assert len(eps) == 2
    assert_episodes_close(eps, jeps, TEACHER_TOL)


@pytest.mark.slow
def test_capture_teacher_matches_jax_in_f32():
    """JAX's capture teacher as it is (its solve pinned to f32, rho up to 1e8,
    2 starts, 3 ticks, the filter off) against the port's: a 1e-7 move of the
    starts moves JAX's own states by 0.37 and actions by 15 (measured), so
    the port is held within 10x JAX's own move under that move (slow: JAX
    compiles for two minutes a run)."""
    x0 = expert_gen.capture_starts(2, seed=0).astype(np.float64)
    kw = dict(n_episodes=2, ep_len=3, noise_std=0.0, tol=100.0)
    eps = expert_gen.generate_cartpole2l_capture_expert(make_env("cartpole2link"), x0=x0,
                                                        device="cpu", **kw)
    jenv = jax_make_env("cartpole2link")
    jeps = jax_eg.generate_cartpole2l_capture_expert(jenv, x0=x0, **kw)
    jeps_moved = jax_eg.generate_cartpole2l_capture_expert(jenv, x0=x0 + 1e-7, **kw)
    assert_within(eps, jeps, _moved_spread(jeps, jeps_moved, 1e-7))


# -- the CLI ---------------------------------------------------------------------------

def test_expert_gen_cli_appends_to_the_committed_episodes(tmp_path):
    """`--append` onto a new `--out` starts from the committed dataset's
    episodes; a second call appends to the file; `data/` is untouched."""
    out = tmp_path / "pend.pkl"
    committed = datagen.load_expert_pickle(datagen.expert_data_path("Pendulum-v0", "mpc"))
    argv = ["--env", "pendulum", "--episodes", "3", "--ep_len", "5", "--cpu", "--append",
            "--out", str(out)]
    _, eps = expert_gen.main(argv)
    assert len(eps) == len(committed) + 3
    np.testing.assert_array_equal(eps[0][0][0], committed[0][0][0])
    _, eps2 = expert_gen.main(argv)
    assert len(eps2) == len(committed) + 6
    assert len(datagen.load_expert_pickle(out)) == len(committed) + 6
    with pytest.raises(ValueError, match="committed data"):
        datagen.write_episodes(datagen.DATA_DIR / "x.pkl", [])
    assert datagen.port_data_path("Pendulum-v0", "sac").parent.name == "data_port"
    assert subprocess.run(["git", "status", "--porcelain", "data"], capture_output=True,
                          text=True, cwd=datagen.DATA_DIR.parent).stdout == ""


# -- the golden trajectory ------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    d = np.load(golden_traj.GOLDEN_PATH)
    return d["X"], d["U"]


def test_golden_constants_and_defect_match_jax(golden):
    assert golden_traj.T == jax_golden.T and golden_traj.R_REG == jax_golden.R_REG
    np.testing.assert_array_equal(golden_traj.X0, jax_golden.X0)
    X, U = golden
    d = golden_traj.rollout_defect(X, U)
    assert d < 1e-3
    np.testing.assert_allclose(d, jax_golden.rollout_defect(X, U), rtol=1e-6, atol=1e-14)
    U_moved = U + 1e-3
    np.testing.assert_allclose(golden_traj.rollout_defect(X, U_moved),
                               jax_golden.rollout_defect(X, U_moved), **TOL)


def test_solve_al_reproduces_the_golden(golden):
    """In f64, within JAX's own test's limits (`test_golden_traj.py`)."""
    X, U = golden
    X_al, U_al = golden_traj.solve_al(device="cpu")
    assert golden_traj.rollout_defect(X_al, U_al) < 1e-4
    np.testing.assert_allclose(U_al, U, atol=2e-3)
    np.testing.assert_allclose(X_al, X, atol=2e-4)


@pytest.mark.slow
def test_solve_ip_two_sqp_iterations_matches_jax():
    """Slow: JAX's IP solve compiles for 25 s alone, and took 190 s beside the
    tier-1 run's other workers (the card checks it against the CPU every smoke)."""
    X, U = golden_traj.solve_ip(qp_iter=2, device="cpu")
    jX, jU = jax_golden.solve_ip(qp_iter=2)
    np.testing.assert_allclose(X, jX, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(U, jU, rtol=1e-8, atol=1e-8)


@pytest.mark.slow
def test_solve_ip_matches_jax_and_its_distance_from_the_golden(golden):
    X, U = golden_traj.solve_ip(device="cpu")
    jX, jU = jax_golden.solve_ip()
    np.testing.assert_allclose(X, jX, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(U, jU, rtol=1e-8, atol=1e-8)
    # JAX's IP solve no longer reproduces its own golden, nor does the port's
    gX, _ = golden
    assert math.isclose(np.abs(X - gX).max(), np.abs(jX - gX).max(), rel_tol=1e-8)
