"""The port's envs against the JAX package: dynamics and Jacobians in f64."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.envs import PendulumEnv as JaxPendulum  # noqa: E402
from deqmpc_tpu.envs import RexQuadrotor as JaxQuad  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402

torch.set_num_threads(2)

ENVS = {"pendulum": JaxPendulum, "rexquadrotor": JaxQuad}


def _inputs(env, lead, seed):
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.normal(size=lead + (env.nx,))
    mid = (env.action_space.low + env.action_space.high) / 2.0
    half = (env.action_space.high - env.action_space.low) / 2.0
    u = mid + 1.2 * half * rng.uniform(-1, 1, size=lead + (env.nu,))
    return x, u


@pytest.mark.parametrize("name", sorted(ENVS))
@pytest.mark.parametrize("lead", [(7,), (3, 4)])
def test_dynamics_and_derivatives_match_jax(name, lead):
    jenv, tenv = ENVS[name](), make_env(name)
    x, u = _inputs(tenv, lead, seed=len(lead))
    y_ref = np.asarray(jenv.dynamics(jnp.asarray(x), jnp.asarray(u)))
    y = tenv.dynamics(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-10, atol=1e-10)
    xn_ref, (Jx_ref, Ju_ref) = jenv.dynamics_derivatives(jnp.asarray(x), jnp.asarray(u))
    with torch.inference_mode():
        xn, (Jx, Ju) = tenv.dynamics_derivatives(torch.as_tensor(x), torch.as_tensor(u))
    assert Jx.shape == lead + (tenv.nx, tenv.nx) and Ju.shape == lead + (tenv.nx, tenv.nu)
    np.testing.assert_allclose(xn.numpy(), np.asarray(xn_ref), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(Jx.numpy(), np.asarray(Jx_ref), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(Ju.numpy(), np.asarray(Ju_ref), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_f32_jacobians_stay_f32(name):
    env = make_env(name)
    x, u = (torch.as_tensor(a, dtype=torch.float32) for a in _inputs(env, (5,), seed=3))
    with torch.inference_mode():
        xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
    assert xn.dtype == Jx.dtype == Ju.dtype == torch.float32


@pytest.mark.parametrize("name", sorted(ENVS))
def test_step_and_reward_match_jax(name):
    jenv, tenv = ENVS[name](), make_env(name)
    x, u = _inputs(tenv, (6,), seed=4)
    xj, rj = jenv.step(jnp.asarray(x), jnp.asarray(u))
    xt, rt = tenv.step(torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_reset_is_seeded_and_in_range(name):
    env = make_env(name)
    a = env.reset(torch.Generator().manual_seed(3), 64, device="cpu")
    b = env.reset(torch.Generator().manual_seed(3), 64, device="cpu")
    assert a.shape == (64, env.nx) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    if name == "rexquadrotor":
        assert (a[:, :3].abs() <= 5.0).all()
        # MRP of an attitude within 70 degrees per Euler angle
        assert (a[:, 3:6].norm(dim=-1) < 1.0).all()
    else:
        assert ((a[:, 0] >= 0) & (a[:, 0] <= 2 * np.pi)).all()


def test_reset_without_a_card_raises_when_no_device_is_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = make_env("pendulum")
    with pytest.raises(RuntimeError, match="is_available"):
        env.reset(torch.Generator().manual_seed(0), 2)
