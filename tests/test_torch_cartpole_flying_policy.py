"""Configs #2, #3 and #3b as a whole, the port against the JAX package in
f64: the feed-forward network of deq-mpc-nn, the policy forward of the
cartpole (T 10), the flying cartpole (deq-mpc-nn) and the flying cartpole
with obstacle rows (hdim 32, N 2, within 1e-7), a training step's loss and
every parameter gradient (bsz 4, rtol 1e-9), and tick 0 of the three
committed checkpoints at full width (4 states, first actions within the
f64 tick-0 limits of PERF.md: median <= 1e-4, 75th percentile <= 1e-3).

The full-width JAX reference jits the network call and the NewtonAL solve
alone (jitted whole, XLA compiles it for minutes). With obstacles, the
selected set goes into the jitted solve as an argument: the JAX solver
reads it from its own state, which a jit would freeze at its first call."""
import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deqmpc_tpu.envs import make_env as jax_make_env  # noqa: E402
from deqmpc_tpu.models.deq_layer import DEQLayerConfig as JaxDEQLayerConfig  # noqa: E402
from deqmpc_tpu.models.deq_layer import FFDNetwork as JaxFFDNetwork  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import DEQMPCPolicy as JaxPolicy  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import PolicyConfig as JaxPolicyConfig  # noqa: E402
from deqmpc_tpu.solvers import ObstacleSet as JaxObstacleSet  # noqa: E402
from deqmpc_tpu.training import train as jax_train  # noqa: E402
from deqmpc_tpu_torch import data as port_data  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.models import DEQLayerConfig, FFDNetwork  # noqa: E402
from deqmpc_tpu_torch.policies import DEQMPCPolicy, PolicyConfig, build_policy  # noqa: E402
from deqmpc_tpu_torch.solvers import ObstacleSet  # noqa: E402
from deqmpc_tpu_torch.training import train  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint, params_from_jax  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
POLICY_TOL = dict(rtol=1e-7, atol=1e-7)
STEP_TOL = dict(rtol=1e-9, atol=1e-11)
HDIM, N, BSZ = 32, 2, 4
# env name, T, nq, deq_type, obstacle radius (None: no obstacles)
CASES = {"cartpole": ("cartpole1link", 10, 2, "deq", None),
         "flying_nn": ("FlyingCartpole", 5, 7, "nn", None),
         "flying_obstacles": ("FlyingCartpole_obstacles", 5, 7, "nn", 0.25)}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), **tol, err_msg=msg)


class _Jitted:
    """A JAX module whose __call__ is jitted once."""

    def __init__(self, module):
        self._module, self._call = module, jax.jit(module.__call__)

    def __call__(self, *args):
        return self._call(*args)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _jit_pieces(jpol):
    """Jit the JAX policy's network call and NewtonAL solve, each once. The
    solve reads the selected obstacles from the solver's state
    (`_obs_current`): they go in as an argument, and the state is put back
    after each call."""
    jpol.model = _Jitted(jpol.model)
    ctrl = jpol.tracking_mpc.ctrl
    raw = ctrl._newton
    if ctrl._all_obstacles is None:
        ctrl._newton = jax.jit(raw)
        return jpol
    radius = ctrl._all_obstacles.radius

    @jax.jit
    def newton_obs(centers, *args):
        ctrl._obs_current = JaxObstacleSet(centers, radius)
        return raw(*args)

    def call(*args):
        obs = ctrl._obs_current
        try:
            return newton_obs(obs.centers, *args)
        finally:
            ctrl._obs_current = obs

    ctrl._newton = call
    return jpol


def _field(env_name, radius):
    env = make_env(env_name)
    if radius is None:
        return env, None, None
    return (env, JaxObstacleSet(jnp.asarray(env.obstacle_positions), radius),
            ObstacleSet(torch.as_tensor(env.obstacle_positions), radius))


def _policies(case, seed, jit_pieces=True):
    """The JAX policy (pieces jitted, or none) with f64 parameters, and the
    port's policy loaded with them."""
    env_name, T, nq, deq_type, radius = CASES[case]
    env, jobs, tobs = _field(env_name, radius)
    kw = dict(nx=env.nx, nu=env.nu, nq=nq, T=T, dt=env.dt, hdim=HDIM, deq_iter=N,
              rho_max=1e5, deq_type=deq_type)
    jpol = JaxPolicy(JaxPolicyConfig(**kw, solver_dtype=jnp.float64), jax_make_env(env_name),
                     obstacles=jobs)
    params = jpol.init(jax.random.PRNGKey(seed))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(np.asarray(leaf, np.float64) + 0.05 * rng.normal(size=leaf.shape))
        for leaf in leaves])
    pol = DEQMPCPolicy(PolicyConfig(**kw, solver_dtype=torch.float64), env, device="cpu",
                       obstacles=tobs)
    pol.model.double()  # before loading: the f64 params must not pass through f32
    pol.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return env, _jit_pieces(jpol) if jit_pieces else jpol, params, pol


def _start_states(env, n, seed, near_obstacles=False):
    obs = env.reset(torch.Generator().manual_seed(seed), n, device="cpu", dtype=torch.float64)
    if near_obstacles:  # start beside a sphere: the first knots' rows are active
        obs[:, :3] = torch.as_tensor(env.obstacle_positions[:n]) + 0.1
    return obs


def test_ffd_network_matches_jax():
    env = make_env("flyingcartpole")
    kw = dict(nx=env.nx, nu=env.nu, nq=7, T=5, dt=env.dt, hdim=HDIM, deq_iter=N)
    jnet = JaxFFDNetwork(JaxDEQLayerConfig(**kw))
    assert jnet.cfg.fp_type == "single"
    params = jnet.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64) + 0.05 * rng.normal(size=a.shape)),
        params)
    obs, x_prev = rng.normal(size=(3, env.nx)), rng.normal(size=(3, 5, env.nx))
    z = rng.normal(size=(3, 4, HDIM))
    ref, ref_aux = jax.jit(jnet.__call__)(params, {"o": jnp.asarray(obs)},
                                          {"x": jnp.asarray(x_prev), "z": jnp.asarray(z)})
    net = FFDNetwork(DEQLayerConfig(**kw)).double()
    assert net.cfg.fp_type == "single"
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    zt = torch.as_tensor(z).requires_grad_()
    out, z_out = net(torch.as_tensor(obs), torch.as_tensor(x_prev), zt)
    tol = dict(rtol=1e-8, atol=1e-10)
    _close(out["x_ref"], ref["x_ref"], tol, "x_ref")
    _close(z_out, ref_aux["z"], tol, "z")
    # one cell application, with the gradient reaching the carried z
    torch.autograd.grad(z_out.sum(), zt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_forward_matches_jax(case):
    env, jpol, params, pol = _policies(case, seed=7)
    obs = _start_states(env, BSZ, 1, near_obstacles=case == "flying_obstacles")
    ref, ref_carry = jpol.forward(params, jnp.asarray(obs.numpy()))
    with torch.inference_mode():
        out = pol.forward(obs)
    assert len(out["trajs"]) == len(ref["trajs"]) == N
    for i, (got, r) in enumerate(zip(out["trajs"], ref["trajs"])):
        for name, a, b in zip(("x_ref", "x", "u"), got, r):
            _close(a, b, POLICY_TOL, f"round {i} {name}")
    _close(out["carry"].solver.lam, ref_carry.solver.lam,
           dict(rtol=1e-7, atol=1e-7 * float(np.max(ref_carry.solver.rho))), "lam")
    ncon = pol.tracking_mpc.ctrl.ncon
    assert out["carry"].solver.lam.shape[1] == ncon
    if case == "flying_obstacles":
        # the obstacle rows were active: their duals moved
        off = pol.T * env.nx + 2 * env.nu * pol.T
        assert ncon == off + 4 * pol.T
        assert np.abs(_np(out["carry"].solver.lam)[:, off:]).max() > 1e-3


def _batch(case, T):
    env_name = CASES[case][0]
    env = make_env(env_name)
    teacher = "sac" if case == "cartpole" else "mpc"
    gt, _ = train.split_episodes(port_data.get_gt_data(env, teacher)[:40])
    batch = port_data.sample_trajectory(gt, BSZ, 1, T, np.random.default_rng(11))
    return train.preprocess_batch(env_name, env.nx, batch)


@pytest.mark.parametrize("case", ["cartpole", "flying_obstacles"])
def test_train_step_loss_and_gradients_match_jax(case):
    env, jpol, params, pol = _policies(case, seed=5, jit_pieces=False)
    batch = _batch(case, pol.T)
    if case == "flying_obstacles":  # windows moved to start beside a sphere
        shift = env.obstacle_positions[:BSZ] + 0.1 - batch["obs"][:, -1, :3]
        batch["obs"][..., :3] += shift[:, None].astype(np.float32)
        batch["state"][..., :3] += shift[:, None].astype(np.float32)
    opt = optax.chain(optax.clip_by_global_norm(2.0), optax.adam(1e-3))
    _, loss_fn = jax_train.make_train_step(
        jpol, opt, types.SimpleNamespace(qp_solve=True, lastqp_solve=False))
    jbatch = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in batch.items()}
    # jitted whole: the solver's closure over the selected obstacles is
    # then a value of the one trace
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jbatch, jnp.ones((N, 3)))
    d = train.loss_fn(pol, train.to_device(batch, "cpu", torch.float64))
    d["loss"].backward()
    assert pol.backward_solves == N
    _close(d["loss"], loss, STEP_TOL, "loss")
    _close(d["loss_end"], aux["loss_end"], STEP_TOL, "loss_end")
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    got = dict(pol.model.named_parameters())
    assert set(ref) == set(got)
    for name, g_ref in ref.items():
        if name == "iter_emb":  # unused by the forward: JAX zeros, no torch grad
            assert got[name].grad is None and not g_ref.numpy().any()
            continue
        # rtol 1e-9 of each entry, or 1e-9 of the tensor's largest entry:
        # with obstacle rows the gaps reach 1.4e-10 of the largest entry on
        # entries near 0 (cell.Conv_0.kernel: 2.5e-11 on a tensor whose
        # largest is 0.18), and a 1e-14 relative move of the batch moves
        # JAX's own gradient there by 2.2e-11
        tol = dict(rtol=STEP_TOL["rtol"], atol=STEP_TOL["rtol"] * float(g_ref.abs().max()))
        _close(got[name].grad, g_ref, tol, name)
    assert np.abs(_np(got["out.Conv_1.kernel"].grad)).max() > 1e-4


@pytest.mark.parametrize("ckpt", ["cartpole_sac_deqmpc", "flying_deqmpc_nn",
                                  "flying_obstacles", "cartpole_deqmpc", "pendulum_sac_deqmpc"])
def test_checkpoint_first_actions_match_jax_in_f64(ckpt):
    """A committed checkpoint at full width (hdim 256, N 6), loaded by each
    package's own reader, tick 0 of 4 seeded start states in f64
    (`cartpole_deqmpc`: cartpole T 10, the MPC teacher's; `pendulum_sac_deqmpc`:
    pendulum T 5, the SAC teacher's)."""
    path = REPO / "checkpoints" / ckpt
    state, args = load_checkpoint(path, "cpu")
    env = make_env(args["env"])
    cfg = build_policy(args, env, "cpu", obstacles=train.build_obstacles(env)).cfg
    assert (cfg.hdim, cfg.deq_iter, cfg.rho_max) == (256, 6, 1e5)
    assert cfg.deq_type == ("nn" if ckpt.startswith("flying") else "deq")
    pol = DEQMPCPolicy(dataclasses.replace(cfg, solver_dtype=torch.float64), env, device="cpu",
                       obstacles=train.build_obstacles(env))
    pol.model.double()
    pol.model.load_state_dict(state)
    _, jobs, _ = _field(args["env"], 0.25 if ckpt == "flying_obstacles" else None)
    jpol = JaxPolicy(JaxPolicyConfig(nx=env.nx, nu=env.nu, nq=cfg.nq, T=cfg.T, dt=env.dt,
                                     hdim=cfg.hdim, deq_iter=cfg.deq_iter, rho_max=cfg.rho_max,
                                     deq_type=cfg.deq_type, solver_dtype=jnp.float64),
                     jax_make_env(args["env"]), obstacles=jobs)
    params, _, _, _ = jax_train.load_checkpoint(str(path), jpol.init(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    _jit_pieces(jpol)
    obs = _start_states(env, 4, 2)
    ref, _ = jpol.forward(params, jnp.asarray(obs.numpy()))
    with torch.inference_mode():
        u = _np(pol.forward(obs)["trajs"][-1][2][:, 0])
    gap = np.abs(u - np.asarray(ref["trajs"][-1][2][:, 0])).max(axis=-1)
    assert np.isfinite(u).all()
    assert np.median(gap) <= 1e-4 and np.quantile(gap, 0.75) <= 1e-3, gap
