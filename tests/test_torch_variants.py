"""The policy-variant family's networks, the port against the JAX package in
f64: the mlp blocks and the gated memory update against flax's apply, the
straight-through scale multiply, `grad_norm`, `jac_loss_estimate` and
`update_scales` against theirs, and each of the seven variant layers
(hdim 32, N 2, T 5, H 3; the iteration embeddings read at a warm tick's
clamped iter). The policies are in `test_torch_variants_policy.py`.

Tolerances: 1e-10 for the blocks (a few layers of rounding); 1e-12 for
`update_scales` (medians and one multiply-add); 1e-7 for the layers, as
the base layer's parity (`test_torch_policy.py`): Anderson's ten steps
amplify rounding."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.models import blocks as jax_blocks  # noqa: E402
from deqmpc_tpu.models import deq_layer_variants as jax_variants  # noqa: E402
from deqmpc_tpu.models import grad_layers as jax_grad_layers  # noqa: E402
from deqmpc_tpu.models.deq_layer import DEQLayerConfig as JaxDEQLayerConfig  # noqa: E402
from deqmpc_tpu_torch.models import blocks, deq_layer_variants, grad_layers  # noqa: E402
from deqmpc_tpu_torch.models.deq_layer import DEQLayerConfig  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import params_from_jax  # noqa: E402
from torch_variant_pairs import BSZ, H, HDIM, N, T  # noqa: E402

torch.set_num_threads(2)

BLOCK_TOL = dict(rtol=1e-10, atol=1e-10)
LAYER_TOL = dict(rtol=1e-7, atol=1e-7)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64) + 0.05 * rng.normal(size=a.shape)),
        params)


def _load(module, params):
    module.double().load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return module


# -- blocks -------------------------------------------------------------------------

BLOCKS = {
    "mlp_cell": (lambda: jax_blocks.MLPCell(hdim=8), lambda: blocks.MLPCell(8), 2),
    "mlp_input": (lambda: jax_blocks.MLPInput(hdim=8), lambda: blocks.MLPInput(6, 8), 1),
    "mlp_output": (lambda: jax_blocks.MLPOutput(out_dim=5), lambda: blocks.MLPOutput(8, 5), 1),
    "gated_residual": (lambda: jax_blocks.GatedResidual(dim=8, bypass=False),
                       lambda: blocks.GatedResidual(8, bypass=False), 2),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_blocks_match_flax(name):
    make_jax, make_port, n_in = BLOCKS[name]
    rng = np.random.default_rng(0)
    width = 6 if name == "mlp_input" else 8
    xs = [rng.normal(size=(3, width)) for _ in range(n_in)]
    mod = make_jax()
    params = _perturbed(mod.init(jax.random.PRNGKey(0), *map(jnp.asarray, xs)), 0)
    ref = mod.apply(params, *map(jnp.asarray, xs))
    got = _load(make_port(), params)(*map(torch.as_tensor, xs))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **BLOCK_TOL)


def test_mish_matches_jax():
    x = np.linspace(-30, 30, 301)
    np.testing.assert_allclose(_np(blocks.get_act("mish")(torch.as_tensor(x))),
                               np.asarray(jax_blocks.get_act("mish")(jnp.asarray(x))),
                               **BLOCK_TOL)


# -- custom gradients and the scales' EMA ----------------------------------------------

def test_scale_multiply_st_and_grad_norm_match_custom_vjp():
    rng = np.random.default_rng(1)
    x, s, g = (rng.normal(size=(4, 6)) for _ in range(3))
    ref, vjp = jax.vjp(jax_variants.scale_multiply_st, jnp.asarray(x), jnp.asarray(s))
    dx_ref, ds_ref = vjp(jnp.asarray(g))
    xt, st = torch.as_tensor(x).requires_grad_(), torch.as_tensor(s).requires_grad_()
    out = deq_layer_variants.scale_multiply_st(xt, st)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-15, atol=0)
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(dx_ref))  # straight through
    np.testing.assert_allclose(_np(st.grad), np.asarray(ds_ref), rtol=1e-15, atol=0)
    assert not np.allclose(_np(xt.grad), g * s)  # not the product rule

    ref, vjp = jax.vjp(jax_grad_layers.grad_norm, jnp.asarray(x.reshape(2, 2, 6)))
    (dx_ref,) = vjp(jnp.asarray(g.reshape(2, 2, 6)))
    xt = torch.as_tensor(x.reshape(2, 2, 6)).requires_grad_()
    out = grad_layers.grad_norm(xt)
    out.backward(torch.as_tensor(g.reshape(2, 2, 6)))
    np.testing.assert_array_equal(_np(out), x.reshape(2, 2, 6))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(dx_ref), rtol=1e-13, atol=1e-15)


def test_jac_loss_estimate_matches_jax_with_the_same_probes():
    cell = jax_blocks.MLPCell(hdim=8)
    rng = np.random.default_rng(2)
    inj, z0 = rng.normal(size=(3, 8)), rng.normal(size=(3, 8))
    params = _perturbed(cell.init(jax.random.PRNGKey(2), jnp.asarray(inj), jnp.asarray(z0)), 2)
    key = jax.random.PRNGKey(5)
    ref = jax_grad_layers.jac_loss_estimate(
        lambda z: cell.apply(params, jnp.asarray(inj), z), jnp.asarray(z0), key, vecs=2)
    # the probe vectors JAX drew
    probes = np.stack([np.asarray(jax.random.normal(k, z0.shape, jnp.float64))
                       for k in jax.random.split(key, 2)])
    port = _load(blocks.MLPCell(8), params)
    got = grad_layers.jac_loss_estimate(lambda z: port(torch.as_tensor(inj), z),
                                        torch.as_tensor(z0), probes=torch.as_tensor(probes))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-10)
    got.backward()  # differentiable in the cell's parameters
    assert port.Dense_0.weight.grad.abs().max() > 0


@pytest.mark.parametrize("bsz", [4, 5])
def test_update_scales_matches_jax(bsz):
    """At an even batch the median is the mean of the two middle values."""
    rng = np.random.default_rng(bsz)
    scales = rng.uniform(0.5, 2, size=(N + 1, T - 1, 2))
    trajs = [rng.normal(size=(bsz, T, 2)) for _ in range(N + 1)]
    gt, init = rng.normal(size=(bsz, T, 2)), rng.normal(size=(bsz, T, 2))
    ref = jax_grad_layers.update_scales(jnp.asarray(scales), [jnp.asarray(t) for t in trajs],
                                        jnp.asarray(gt), jnp.asarray(init))
    got = grad_layers.update_scales(torch.as_tensor(scales), [torch.as_tensor(t) for t in trajs],
                                    torch.as_tensor(gt), torch.as_tensor(init))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-12, atol=1e-12)
    lower = np.sort(np.abs(gt[:, 1:] - init[:, 1:]), axis=0)[(bsz - 1) // 2]
    if bsz % 2 == 0:  # torch.median's lower middle value would not do
        assert not np.allclose(_np(got)[0], scales[0] * 0.98 + 0.02 * lower)


# -- the seven variant layers -----------------------------------------------------------

def _layer_cfg(lib, layer_type="gcn"):
    cls = JaxDEQLayerConfig if lib == "jax" else DEQLayerConfig
    return cls(nx=2, nu=1, nq=1, T=T, dt=0.05, hdim=HDIM, layer_type=layer_type, deq_iter=N)


LAYERS = {  # name -> (JAX layer, port layer, trunk, history input)
    "mem": (lambda c: jax_variants.DEQLayerMem(c), deq_layer_variants.DEQLayerMem, "gcn", 0),
    "mem_gated": (lambda c: jax_variants.DEQLayerMem(c, mem_bypass=False),
                  lambda c: deq_layer_variants.DEQLayerMem(c, mem_bypass=False), "gcn", 0),
    "delta": (jax_variants.DEQLayerDelta, deq_layer_variants.DEQLayerDelta, "mlp", 0),
    "history_state": (lambda c: jax_variants.DEQLayerHistoryState(c, H),
                      lambda c: deq_layer_variants.DEQLayerHistoryState(c, H), "gcn", H),
    "estpred": (lambda c: jax_variants.DEQLayerHistoryStateEstPred(c, H),
                lambda c: deq_layer_variants.DEQLayerHistoryStateEstPred(c, H), "gcn", H),
    "history": (lambda c: jax_variants.DEQLayerHistory(c, H),
                lambda c: deq_layer_variants.DEQLayerHistory(c, H), "mlp", H),
    "feedback": (jax_variants.DEQLayerFeedback, deq_layer_variants.DEQLayerFeedback, "gcn", 0),
    "feedback_mlp": (jax_variants.DEQLayerFeedback, deq_layer_variants.DEQLayerFeedback,
                     "mlp", 0),
    "q": (jax_variants.DEQLayerQ, deq_layer_variants.DEQLayerQ, "gcn", 0),
    "q_mlp": (jax_variants.DEQLayerQ, deq_layer_variants.DEQLayerQ, "mlp", 0),
}


def _tree(z, f):
    return tuple(f(a) for a in z) if isinstance(z, tuple) else f(z)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_variant_layer_matches_jax(name):
    make_jax, make_port, trunk, h = LAYERS[name]
    jlayer = make_jax(_layer_cfg("jax", trunk))
    params = _perturbed(jlayer.init(jax.random.PRNGKey(3)), 3)
    layer = _load(make_port(_layer_cfg("port", trunk)), params)
    assert set(layer.state_dict()) == set(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(BSZ, h, 2) if h else (BSZ, 2))
    z = _tree(jlayer.init_z(BSZ), lambda a: rng.normal(size=a.shape))
    aux = {"x": rng.normal(size=(BSZ, T, 2)), "u": rng.normal(size=(BSZ, T, 1)), "z": z,
           "xn": rng.normal(size=(BSZ, T, 2)), "q": rng.uniform(0, 2, size=(BSZ, T)),
           "mem": rng.normal(size=(BSZ, T - 1, HDIM)), "x_est": rng.normal(size=(BSZ, H, 2)),
           # a warm tick's iter, beyond the last embedding: clamped to N - 1
           "iter": N + 1}
    jaux = {k: v if k == "iter" else _tree(v, jnp.asarray) for k, v in aux.items()}
    ref_mpc, ref_aux = jax.jit(jlayer.__call__)(params, {"o": jnp.asarray(obs)}, jaux)
    taux = {k: v if k == "iter" else _tree(v, torch.as_tensor) for k, v in aux.items()}
    with torch.no_grad():
        out_mpc, out_aux = layer.step(torch.as_tensor(obs), taux)
    for key in ref_mpc:
        np.testing.assert_allclose(_np(out_mpc[key]), np.asarray(ref_mpc[key]), **LAYER_TOL,
                                   err_msg=key)
    for key in ("x", "u", "z", "mem", "old_mem", "xn", "q", "x_est"):
        if key in ref_aux:
            for a, b in zip(_tree(out_aux[key], _np), _tree(ref_aux[key], np.asarray)):
                np.testing.assert_allclose(a, b, **LAYER_TOL, err_msg=key)
    if "iter_emb" in params:
        assert int(ref_aux["iter"]) in (N + 1, N - 1) and out_aux["iter"] in (N + 1, N - 1)
