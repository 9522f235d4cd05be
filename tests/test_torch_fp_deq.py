"""The port's Anderson solver and DEQ layer against the JAX package in f64."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.models.deq_layer import DEQLayer as JaxDEQLayer  # noqa: E402
from deqmpc_tpu.models.deq_layer import DEQLayerConfig as JaxDEQLayerConfig  # noqa: E402
from deqmpc_tpu.solvers.fp import anderson as jax_anderson  # noqa: E402
from deqmpc_tpu_torch.models import DEQLayer, DEQLayerConfig  # noqa: E402
from deqmpc_tpu_torch.solvers import anderson  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import params_from_jax  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("max_steps,m", [(10, 5), (4, 5), (9, 3)])
def test_anderson_matches_jax(max_steps, m):
    # a map that is still short of its fixed point after max_steps, as the
    # DEQ cell is: near convergence the mixing system turns singular and
    # the iterates amplify rounding far beyond 1e-8
    rng = np.random.default_rng(max_steps)
    W = 0.95 * rng.normal(size=(3, 64, 64)) / 8.0
    b = rng.normal(size=(3, 64))
    x0 = rng.normal(size=(3, 64))

    def f_j(z):
        return jnp.tanh(jnp.einsum("bi,bij->bj", z, jnp.asarray(W)) + jnp.asarray(b))

    def f_t(z):
        return torch.tanh(torch.einsum("bi,bij->bj", z, torch.as_tensor(W)) + torch.as_tensor(b))

    z_ref, info_ref = jax_anderson(f_j, jnp.asarray(x0), m=m, max_steps=max_steps)
    z, info = anderson(f_t, torch.as_tensor(x0), m=m, max_steps=max_steps)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **TOL)
    np.testing.assert_allclose(info.best_err.numpy(), np.asarray(info_ref.best_err), **TOL)
    np.testing.assert_array_equal(info.best_step.numpy(), np.asarray(info_ref.best_step))
    if max_steps > 2:
        # the accelerated iterate is closer to the fixed point than x0
        assert (np.linalg.norm(f_t(z).numpy() - z.numpy(), axis=1)
                < np.linalg.norm(f_t(torch.as_tensor(x0)).numpy() - x0, axis=1)).all()


def _perturbed_params(layer, seed):
    """JAX-initialised params with every leaf moved off its init value (so
    norm scales and biases are not 1 and 0), kept in f32 like flax's."""
    params = layer.init(jax.random.PRNGKey(seed))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(leaf + 0.1 * rng.normal(size=leaf.shape), np.float32) for leaf in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("env", ["rexquadrotor", "pendulum"])
def test_deq_layer_matches_jax(env):
    nx, nu, nq = (12, 4, 6) if env == "rexquadrotor" else (2, 1, 1)
    kw = dict(nx=nx, nu=nu, nq=nq, T=5, dt=0.05, hdim=32, deq_iter=2, fp_max_steps=4)
    jlayer = JaxDEQLayer(JaxDEQLayerConfig(**kw))
    params = _perturbed_params(jlayer, seed=nx)
    layer = DEQLayer(DEQLayerConfig(**kw)).double()
    layer.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))

    rng = np.random.default_rng(0)
    obs = rng.normal(size=(3, nx))
    x_prev = rng.normal(size=(3, 5, nx))
    z0 = 0.1 * rng.normal(size=(3, 4, 32))
    out_ref, aux_ref = jlayer(params, {"o": jnp.asarray(obs)},
                              {"x": jnp.asarray(x_prev), "z": jnp.asarray(z0)})
    with torch.inference_mode():
        out, z = layer(*(torch.as_tensor(a) for a in (obs, x_prev, z0)))
    np.testing.assert_allclose(z.numpy(), np.asarray(aux_ref["z"]), **TOL)
    np.testing.assert_allclose(out["x_ref"].numpy(), np.asarray(out_ref["x_ref"]), **TOL)
    np.testing.assert_array_equal(out["u_ref"].numpy(), np.asarray(out_ref["u_ref"]))
    np.testing.assert_array_equal(out["x_ref"][:, 0].numpy(), obs)


def test_params_from_jax_layouts():
    """Dense kernels are transposed for nn.Linear; UnfoldConv kernels keep
    their (k, Cin, Cout) layout."""
    kw = dict(nx=12, nu=4, nq=6, T=5, dt=0.05, hdim=32)
    params = jax.tree_util.tree_map(np.asarray, JaxDEQLayer(JaxDEQLayerConfig(**kw)).init(
        jax.random.PRNGKey(0)))
    state = params_from_jax(params)
    dense = params["input"]["params"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(state["input.Dense_0.weight"].numpy(), dense.T)
    conv = params["cell"]["params"]["Conv_0"]["kernel"]
    assert state["cell.Conv_0.kernel"].shape == conv.shape == (3, 32, 128)
    assert set(state) == set(DEQLayer(DEQLayerConfig(**kw)).state_dict())
