"""The obstacle-aware network input, the port against the JAX package in
f64: the nearest-sphere features of every knot (offsets and clearances,
clipped; nearest first, ties to the lower index), the aware DEQ layer on
both trunks (hdim 32), the aware deq-mpc-nn policy on the dense field
(N 2; the features zeroed, the blind input with the aware weights, must
fail), and tick 0 of `checkpoints/flying_obstacles_aware_r5` at full width
on 4 start states (the f64 tick-0 limits of PERF.md: median <= 1e-4,
75th percentile <= 1e-3).

Tolerances: 1e-12 for the features (a few flops); 1e-7 for the layer and
the policy, as the other policy parity tests. The full-width JAX
reference jits the network call and the NewtonAL solve alone, with the
selected obstacles passed into the jitted solve."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.envs import make_env as jax_make_env  # noqa: E402
from deqmpc_tpu.models.deq_layer import DEQLayer as JaxDEQLayer  # noqa: E402
from deqmpc_tpu.models.deq_layer import DEQLayerConfig as JaxDEQLayerConfig  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import DEQMPCPolicy as JaxPolicy  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import PolicyConfig as JaxPolicyConfig  # noqa: E402
from deqmpc_tpu.solvers import ObstacleSet as JaxObstacleSet  # noqa: E402
from deqmpc_tpu.training import train as jax_train  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.models import DEQLayer, DEQLayerConfig  # noqa: E402
from deqmpc_tpu_torch.policies import DEQMPCPolicy, PolicyConfig, build_policy  # noqa: E402
from deqmpc_tpu_torch.training import train  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint, params_from_jax  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ENV = "FlyingCartpole_obstacles_dense"
HDIM, N, BSZ, T = 32, 2, 4, 5
FEAT_TOL = dict(rtol=1e-12, atol=1e-12)
POLICY_TOL = dict(rtol=1e-7, atol=1e-7)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64) + 0.05 * rng.normal(size=a.shape)),
        params)


def _layer_cfgs(centers, radius, layer_type="gcn", nx=14, nu=4):
    kw = dict(nx=nx, nu=nu, nq=7, T=T, dt=0.05, hdim=HDIM, layer_type=layer_type, deq_iter=N,
              obstacle_radius=radius)
    return (JaxDEQLayerConfig(**kw, obstacle_centers=np.asarray(centers)),
            DEQLayerConfig(**kw, obstacle_centers=np.asarray(centers)))


@pytest.mark.parametrize("case", ["field", "ties"])
def test_obstacle_features_match_jax(case):
    if case == "field":
        env = make_env(ENV)
        centers, radius = env.obstacle_positions, float(env.obstacle_radius)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(BSZ, T - 1, 14)) * np.array([3.0] * 3 + [1.0] * 11)
    else:
        # five spheres at distance 1 from the origin: the four kept must be
        # the four lowest indices, in index order; knots far out clip
        centers = np.array([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, -1.0, 0], [0, 0, 1.0],
                            [9.0, 9.0, 9.0]])
        radius = 0.25
        x = np.zeros((2, T - 1, 14))
        x[1, :, :3] = [20.0, 0.0, 0.0]
    jcfg, tcfg = _layer_cfgs(centers, radius)
    ref = np.asarray(JaxDEQLayer(jcfg)._obstacle_feats(jnp.asarray(x)))
    got = _np(DEQLayer(tcfg).double()._obstacle_feats(torch.as_tensor(x)))
    assert got.shape == (x.shape[0], T - 1, 16)
    np.testing.assert_allclose(got, ref, **FEAT_TOL)
    if case == "ties":
        offsets = got[0, 0, :12].reshape(4, 3)
        np.testing.assert_array_equal(offsets, centers[:4])  # spheres 0-3 in order
        np.testing.assert_allclose(got[0, 0, 12:], 0.75, rtol=0, atol=1e-15)
        assert np.abs(got[1]).max() == 5.0  # clipped at obstacle_range
        np.testing.assert_array_equal(got[1, 0, 12:], 5.0)


@pytest.mark.parametrize("layer_type", ["gcn", "mlp"])
def test_aware_layer_matches_jax(layer_type):
    env = make_env(ENV)
    jcfg, tcfg = _layer_cfgs(env.obstacle_positions, float(env.obstacle_radius), layer_type)
    jlayer = JaxDEQLayer(jcfg)
    params = _perturbed(jlayer.init(jax.random.PRNGKey(1)), 1)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(BSZ, 14))
    x_prev = rng.normal(size=(BSZ, T, 14)) * np.array([2.0] * 3 + [1.0] * 11)
    z = rng.normal(size=(BSZ, HDIM) if layer_type == "mlp" else (BSZ, T - 1, HDIM))
    ref, ref_aux = jax.jit(jlayer.__call__)(params, {"o": jnp.asarray(obs)},
                                            {"x": jnp.asarray(x_prev), "z": jnp.asarray(z)})
    layer = DEQLayer(tcfg).double()
    layer.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        out, z_out = layer(torch.as_tensor(obs), torch.as_tensor(x_prev), torch.as_tensor(z))
    np.testing.assert_allclose(_np(out["x_ref"]), np.asarray(ref["x_ref"]), **POLICY_TOL)
    np.testing.assert_allclose(_np(z_out), np.asarray(ref_aux["z"]), **POLICY_TOL)
    assert layer.obstacle_centers.shape == (160, 3)
    assert "obstacle_centers" not in layer.state_dict()


class _Jitted:
    """A JAX module whose __call__ is jitted once."""

    def __init__(self, module):
        self._module, self._call = module, jax.jit(module.__call__)

    def __call__(self, *args):
        return self._call(*args)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _jit_pieces(jpol):
    """Jit the JAX policy's network call and NewtonAL solve, each once; the
    solve reads the selected obstacles from the solver's state, so they go
    into the jitted solve as an argument."""
    jpol.model = _Jitted(jpol.model)
    ctrl = jpol.tracking_mpc.ctrl
    raw, radius = ctrl._newton, ctrl._all_obstacles.radius

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


def _jax_policy(env, cfg):
    jobs = JaxObstacleSet(jnp.asarray(env.obstacle_positions), float(env.obstacle_radius))
    jpol = JaxPolicy(JaxPolicyConfig(nx=env.nx, nu=env.nu, nq=cfg.nq, T=cfg.T, dt=env.dt,
                                     hdim=cfg.hdim, deq_iter=cfg.deq_iter, rho_max=cfg.rho_max,
                                     deq_type=cfg.deq_type, obstacle_net_input=True,
                                     solver_dtype=jnp.float64),
                     jax_make_env(ENV), obstacles=jobs)
    return _jit_pieces(jpol)


def _start_states(env, n, seed):
    """Seeded starts, the first beside a sphere (its features and rows active)."""
    obs = env.reset(torch.Generator().manual_seed(seed), n, device="cpu", dtype=torch.float64)
    obs[:2, :3] = torch.as_tensor(env.obstacle_positions[:2]) + 0.3
    return obs


def _f64_policy(cfg, env, state):
    pol = DEQMPCPolicy(dataclasses.replace(cfg, solver_dtype=torch.float64), env, device="cpu",
                       obstacles=train.build_obstacles(env))
    pol.model.double()  # before loading: the f64 params must not pass through f32
    pol.model.load_state_dict(state)
    return pol


def test_aware_policy_forward_matches_jax(monkeypatch):
    env = make_env(ENV)
    args = {"T": T, "nq": 7, "hdim": HDIM, "deq_iter": N, "deq_type": "nn",
            "obstacle_net_input": True}
    cfg = build_policy(args, env, "cpu", obstacles=train.build_obstacles(env)).cfg
    jpol = _jax_policy(env, cfg)
    params = _perturbed(jpol.init(jax.random.PRNGKey(2)), 2)
    pol = _f64_policy(cfg, env, params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    assert pol.model.input.Conv_0.kernel.shape == (3, 3 * HDIM + 16, 4 * HDIM)
    obs = _start_states(env, BSZ, 3)
    ref, _ = jpol.forward(params, jnp.asarray(obs.numpy()))
    with torch.inference_mode():
        out = pol.forward(obs)
    for i, (got, r) in enumerate(zip(out["trajs"], ref["trajs"])):
        for name, a, b in zip(("x_ref", "x", "u"), got, r):
            np.testing.assert_allclose(_np(a), np.asarray(b), **POLICY_TOL,
                                       err_msg=f"round {i} {name}")
    # a planted fault: the features zeroed (the blind input, aware weights)
    monkeypatch.setattr(DEQLayer, "_obstacle_feats",
                        lambda self, x: torch.zeros(x.shape[:2] + (16,), dtype=x.dtype))
    with torch.inference_mode():
        blind = pol.forward(obs)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(blind["trajs"][-1][2]), np.asarray(ref["trajs"][-1][2]),
                                   **POLICY_TOL)


def test_aware_checkpoint_first_actions_match_jax_in_f64():
    """`checkpoints/flying_obstacles_aware_r5` at full width (hdim 256, N 6,
    the 160-sphere field), loaded by each package's own reader, tick 0 of 4
    seeded start states in f64."""
    path = REPO / "checkpoints" / "flying_obstacles_aware_r5"
    state, args = load_checkpoint(path, "cpu")
    env = make_env(args["env"])
    assert args["obstacle_net_input"] and args["deq_type"] == "nn"
    cfg = build_policy(args, env, "cpu", obstacles=train.build_obstacles(env)).cfg
    assert (cfg.hdim, cfg.deq_iter, cfg.rho_max, cfg.obstacle_net_input) == (256, 6, 1e5, True)
    pol = _f64_policy(cfg, env, state)
    jpol = _jax_policy(env, cfg)
    params, _, _, _ = jax_train.load_checkpoint(str(path), jpol.init(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    obs = _start_states(env, 4, 2)
    ref, _ = jpol.forward(params, jnp.asarray(obs.numpy()))
    with torch.inference_mode():
        u = _np(pol.forward(obs)["trajs"][-1][2][:, 0])
    gap = np.abs(u - np.asarray(ref["trajs"][-1][2][:, 0])).max(axis=-1)
    assert np.isfinite(u).all()
    assert np.median(gap) <= 1e-4 and np.quantile(gap, 0.75) <= 1e-3, gap
