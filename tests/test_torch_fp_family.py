"""The fixed-point family of the port against the JAX package in f64: good
Broyden and the cost-aware Anderson against theirs (the best iterate,
best_err and best_step, a case whose Broyden denominator underflows
included); the DEQ layer under `fp_type` "multi" (last-step gradient and
BPTT), under Broyden, and under `grad_type` "implicit", its output and the
gradient of every parameter against `jax.grad`; the implicit autograd
Function against the `custom_vjp` (output, gradients to the cell's
parameters and to the injection, zero to z0) and against the exact
implicit-function-theorem gradient; the History layer's tuple fixed point
under "multi" and "broyden"; and the solver stats each round reports.

Tolerances: 1e-10 for the solvers (the same arithmetic over at most 20
steps of a map short of its fixed point); 1e-8 for the layers and the
Function (ten solver steps amplify rounding, and the implicit backward runs
the solver once more); the exact IFT gradient within 5e-3 relative, as
`tests/test_implicit_grad.py` holds JAX's, which the one-step gradient
w = g (planted) misses by far; best steps exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.models import deq_layer as jax_deq_layer  # noqa: E402
from deqmpc_tpu.models import deq_layer_variants as jax_variants  # noqa: E402
from deqmpc_tpu.solvers import fp as jax_fp  # noqa: E402
from deqmpc_tpu_torch.models import deq_layer, deq_layer_variants  # noqa: E402
from deqmpc_tpu_torch.solvers import fp  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import params_from_jax  # noqa: E402

torch.set_num_threads(2)

SOLVER_TOL = dict(rtol=1e-10, atol=1e-10)
TOL = dict(rtol=1e-8, atol=1e-8)
HDIM, N, T, BSZ, H = 32, 2, 5, 4, 3


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# -- the solvers ------------------------------------------------------------------------

def _tanh_map(seed, n=48, bsz=3, scale=0.95):
    rng = np.random.default_rng(seed)
    W = scale * rng.normal(size=(bsz, n, n)) / np.sqrt(n)
    b = rng.normal(size=(bsz, n))
    x0 = rng.normal(size=(bsz, n))

    def f_j(z):
        return jnp.tanh(jnp.einsum("bi,bij->bj", z, jnp.asarray(W)) + jnp.asarray(b))

    def f_t(z):
        return torch.tanh(torch.einsum("bi,bij->bj", z, torch.as_tensor(W)) + torch.as_tensor(b))

    return f_j, f_t, x0


def _check_info(z, info, z_ref, info_ref):
    np.testing.assert_allclose(_np(z), np.asarray(z_ref), **SOLVER_TOL)
    np.testing.assert_allclose(_np(info.best_err), np.asarray(info_ref.best_err), **SOLVER_TOL)
    np.testing.assert_allclose(_np(info.final_err), np.asarray(info_ref.final_err),
                               **SOLVER_TOL)
    np.testing.assert_array_equal(_np(info.best_step), np.asarray(info_ref.best_step))


@pytest.mark.parametrize("max_steps,stop_mode", [(8, "abs"), (20, "abs"), (12, "rel")])
def test_broyden_matches_jax(max_steps, stop_mode):
    f_j, f_t, x0 = _tanh_map(max_steps)
    z_ref, info_ref = jax_fp.broyden(f_j, jnp.asarray(x0), max_steps=max_steps,
                                     stop_mode=stop_mode)
    z, info = fp.broyden(f_t, torch.as_tensor(x0), max_steps=max_steps, stop_mode=stop_mode)
    _check_info(z, info, z_ref, info_ref)
    assert (info.best_step > 0).all()  # Broyden moved every sample


def test_broyden_underflowing_denominator_matches_jax():
    """A constant map: the first step lands on the root, the next have
    dg = 0, so dg'dg underflows (guarded to 1) and u is 0/1."""
    rng = np.random.default_rng(3)
    c, x0 = rng.normal(size=(2, 16)), rng.normal(size=(2, 16))
    z_ref, info_ref = jax_fp.broyden(lambda z: jnp.asarray(c) + 0.0 * z, jnp.asarray(x0),
                                     max_steps=5)
    z, info = fp.broyden(lambda z: torch.as_tensor(c) + 0.0 * z, torch.as_tensor(x0),
                         max_steps=5)
    _check_info(z, info, z_ref, info_ref)
    assert np.isfinite(_np(z)).all() and (_np(info.best_err) == 0).all()
    np.testing.assert_allclose(_np(z), c, atol=1e-12)


@pytest.mark.parametrize("max_steps,warmup", [(14, 10), (12, 3)])
def test_anderson_jiio_matches_jax(max_steps, warmup):
    """The cost-aware acceptance on an expanding map whose residual does not
    fall step by step: the cost is each iterate's distance to a point away
    from the fixed point, so it and the residual disagree, and the best
    step is not the last on every sample."""
    f_j, f_t, x0 = _tanh_map(warmup, scale=2.5)
    target = np.random.default_rng(9).normal(size=x0.shape)

    def g_j(z, k):
        out = f_j(z)
        return out, jnp.sum((out - jnp.asarray(target)) ** 2, axis=1)

    def g_t(z, k):
        out = f_t(z)
        return out, torch.sum((out - torch.as_tensor(target)) ** 2, dim=1)

    z_ref, info_ref = jax_fp.anderson_jiio(g_j, jnp.asarray(x0), max_steps=max_steps,
                                           warmup=warmup)
    z, info = fp.anderson_jiio(g_t, torch.as_tensor(x0), max_steps=max_steps, warmup=warmup)
    _check_info(z, info, z_ref, info_ref)
    assert (info.best_step < max_steps - 1).any()


# -- the layer under each fixed point --------------------------------------------------

def _cfgs(**kw):
    base = dict(nx=2, nu=1, nq=1, T=T, dt=0.05, hdim=HDIM, deq_iter=N, fp_max_steps=6, **kw)
    return jax_deq_layer.DEQLayerConfig(**base), deq_layer.DEQLayerConfig(**base)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64) + 0.05 * rng.normal(size=a.shape)),
        params)


def _load(module, params):
    module.double().load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return module


def _layer_pair(seed=4, **kw):
    jcfg, cfg = _cfgs(**kw)
    jlayer = jax_deq_layer.DEQLayer(jcfg)
    params = _perturbed(jlayer.init(jax.random.PRNGKey(seed)), seed)
    return jlayer, params, _load(deq_layer.DEQLayer(cfg), params)


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BSZ, 2)), rng.normal(size=(BSZ, T, 2)),
            0.3 * rng.normal(size=(BSZ, T - 1, HDIM)), rng.normal(size=(BSZ, T, 2)),
            rng.normal(size=(BSZ, T - 1, HDIM)))


def _check_layer_grads(jlayer, params, layer, seed=5):
    """The layer's x_ref and z, the solver stats, and the gradient of
    <x_ref, G> + <z, Gz> to every parameter, against `jax.grad`."""
    obs, x_prev, z0, G, Gz = _layer_inputs(seed)

    def loss_j(p):
        out, aux = jlayer(p, {"o": jnp.asarray(obs)},
                          {"x": jnp.asarray(x_prev), "z": jnp.asarray(z0), "iter": 0})
        return (jnp.sum(out["x_ref"] * jnp.asarray(G)) + jnp.sum(aux["z"] * jnp.asarray(Gz)),
                (out, aux))

    (loss_ref, (out_ref, aux_ref)), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        params)
    out, aux = layer.step(torch.as_tensor(obs), {"x": torch.as_tensor(x_prev),
                                                 "z": torch.as_tensor(z0), "iter": 0})
    loss = torch.sum(out["x_ref"] * torch.as_tensor(G)) + torch.sum(aux["z"] * torch.as_tensor(Gz))
    loss.backward()
    np.testing.assert_allclose(_np(out["x_ref"]), np.asarray(out_ref["x_ref"]), **TOL)
    np.testing.assert_allclose(_np(aux["z"]), np.asarray(aux_ref["z"]), **TOL)
    np.testing.assert_allclose(_np(loss), np.asarray(loss_ref), **TOL)
    for key in ("deq_fwd_err", "deq_fwd_steps"):
        if aux_ref[key] is None:
            assert aux[key] is None, key
        else:
            np.testing.assert_allclose(_np(aux[key]), np.asarray(aux_ref[key]), **TOL,
                                       err_msg=key)
            assert aux[key].dtype == (torch.float32 if key == "deq_fwd_steps" else torch.float64)
    got = dict(layer.named_parameters())
    for key, g in params_from_jax(jax.tree_util.tree_map(np.asarray, grads)).items():
        if got[key].grad is None:  # a parameter the forward does not read
            assert not g.numpy().any(), key
            continue
        np.testing.assert_allclose(got[key].grad.numpy(), g.numpy(), rtol=1e-8,
                                   atol=1e-8 * float(g.abs().max()), err_msg=key)
    return aux


@pytest.mark.parametrize("fp_type,grad_type,inner", [
    ("multi", "last_step_grad", 4), ("multi", "bptt", 4), ("multi", "last_step_grad", 2),
    ("broyden", "fp_grad", 4), ("anderson", "some_free_string", 4),
    ("anderson", "implicit", 4), ("broyden", "implicit", 4)])
def test_layer_fixed_point_and_gradients_match_jax(fp_type, grad_type, inner):
    jlayer, params, layer = _layer_pair(fp_type=fp_type, grad_type=grad_type,
                                        inner_deq_iters=inner)
    aux = _check_layer_grads(jlayer, params, layer)
    assert (aux["deq_fwd_err"] is None) == (fp_type == "multi")


# -- the implicit Function --------------------------------------------------------------

def _cell_pair(seed=6):
    """The layer's ConvCell in both, with a random injection and z0."""
    jlayer, params, layer = _layer_pair(seed)
    rng = np.random.default_rng(seed)
    inj = rng.normal(size=(BSZ, T - 1, HDIM))
    z0 = 0.3 * rng.normal(size=(BSZ, T - 1, HDIM))
    G = rng.normal(size=(BSZ, T - 1, HDIM))
    return jlayer, params, layer, inj, z0, G


@pytest.mark.parametrize("solver", ["anderson", "broyden"])
def test_implicit_function_matches_custom_vjp(solver):
    jlayer, params, layer, inj, z0, G = _cell_pair()
    kw = dict(m=5, max_steps=10) if solver == "anderson" else dict(max_steps=10)
    jfp = jax_deq_layer.make_implicit_fp(
        lambda p, i, zz: jlayer.cell_mod.apply(p, i, zz), getattr(jax_fp, solver), **kw)

    def loss_j(p, i, z):
        z_star, _, _ = jfp(p, i, z)
        return jnp.sum(z_star * jnp.asarray(G)), z_star

    (_, z_ref), (g_p, g_inj, g_z0) = jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True)(
        params["cell"], jnp.asarray(inj), jnp.asarray(z0))
    cell = layer.cell
    inj_t, z0_t = torch.tensor(inj, requires_grad=True), torch.tensor(z0, requires_grad=True)
    z_star, err, step = deq_layer.ImplicitFixedPoint.apply(
        cell, getattr(fp, solver), kw, inj_t, z0_t, *cell.parameters())
    assert not err.requires_grad and not step.requires_grad
    torch.sum(z_star * torch.as_tensor(G)).backward()
    np.testing.assert_allclose(_np(z_star), np.asarray(z_ref), **TOL)
    np.testing.assert_allclose(_np(inj_t.grad), np.asarray(g_inj), **TOL)
    assert not z0_t.grad.numpy().any() and not np.asarray(g_z0).any()
    got = {k: p.grad for k, p in cell.named_parameters()}
    for key, g in params_from_jax({"cell": jax.tree_util.tree_map(np.asarray, g_p)}).items():
        g_port = got[key.split(".", 1)[1]]
        np.testing.assert_allclose(g_port.numpy(), g.numpy(), rtol=1e-8,
                                   atol=1e-8 * float(g.abs().max()), err_msg=key)


class _TanhCell(torch.nn.Module):
    """f(z) = tanh(0.4 z W + inj), contractive (`tests/test_implicit_grad.py`)."""

    def __init__(self, W):
        super().__init__()
        self.W = torch.nn.Parameter(torch.as_tensor(W))

    def forward(self, inj, z):
        return torch.tanh(0.4 * z @ self.W + inj)


def _ift_gap(hdim=8, bsz=3):
    """Relative gap of the Function's parameter gradient to the exact IFT
    gradient w = (I - J')^-1 g, then one VJP."""
    rng = np.random.default_rng(0)
    cell = _TanhCell(rng.normal(size=(hdim, hdim)) / np.sqrt(hdim))
    inj = torch.as_tensor(0.3 * rng.normal(size=(bsz, hdim)))
    g = torch.as_tensor(rng.normal(size=(bsz, hdim)))
    z0 = torch.zeros(bsz, hdim, dtype=torch.float64, requires_grad=True)
    kw = dict(m=5, max_steps=60)
    z_star, _, _ = deq_layer.ImplicitFixedPoint.apply(cell, fp.anderson, kw, inj, z0, cell.W)
    (z_star * g).sum().backward()
    zs = z_star.detach()
    assert float((cell(inj, zs) - zs).abs().max()) < 1e-6  # converged
    w = torch.zeros_like(g)
    for b in range(bsz):
        J = torch.autograd.functional.jacobian(lambda zz: cell(inj[b:b + 1], zz[None])[0], zs[b])
        w[b] = torch.linalg.solve(torch.eye(hdim, dtype=J.dtype) - J.T, g[b])
    W = cell.W.detach().requires_grad_()
    exact, = torch.autograd.grad(torch.tanh(0.4 * zs @ W + inj), W, w)
    assert not z0.grad.any()
    return float(torch.linalg.norm(cell.W.grad - exact) / torch.linalg.norm(exact))


def test_implicit_function_matches_the_exact_ift_gradient():
    assert _ift_gap() < 5e-3


def test_planted_one_step_gradient_fails_the_ift_check(monkeypatch):
    monkeypatch.setattr(deq_layer, "adjoint_solve", lambda vjp_z, g, solver, kw: g)
    assert _ift_gap() > 5e-3


# -- the History layer's tuple fixed point ----------------------------------------------

@pytest.mark.parametrize("fp_type,grad_type", [("multi", "last_step_grad"),
                                               ("broyden", "implicit"), ("single", "fp_grad")])
def test_history_tuple_fixed_point_matches_jax(fp_type, grad_type):
    """JAX's own rules: multi applies the cell inner_deq_iters times with the
    gradient (last_step_grad ignored), Broyden runs Anderson and implicit is
    not taken."""
    jcfg, cfg = _cfgs(fp_type=fp_type, grad_type=grad_type)
    jlayer = jax_variants.DEQLayerHistoryState(jcfg, H)
    params = _perturbed(jlayer.init(jax.random.PRNGKey(7)), 7)
    layer = _load(deq_layer_variants.DEQLayerHistoryState(cfg, H), params)
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(BSZ, H, 2))
    x_prev = rng.normal(size=(BSZ, T, 2))
    z0 = tuple(0.3 * rng.normal(size=a.shape) for a in jlayer.init_z(BSZ))
    G = rng.normal(size=(BSZ, T, 2))

    def loss_j(p):
        out, aux = jlayer(p, {"o": jnp.asarray(obs)},
                          {"x": jnp.asarray(x_prev), "z": tuple(map(jnp.asarray, z0))})
        return jnp.sum(out["x_ref"] * jnp.asarray(G)), aux

    (loss_ref, aux_ref), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    out, aux = layer.step(torch.as_tensor(obs), {"x": torch.as_tensor(x_prev),
                                                 "z": tuple(map(torch.as_tensor, z0))})
    loss = torch.sum(out["x_ref"] * torch.as_tensor(G))
    loss.backward()
    np.testing.assert_allclose(_np(loss), np.asarray(loss_ref), **TOL)
    for a, b in zip(aux["z"], aux_ref["z"]):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    if aux_ref["deq_fwd_err"] is None:
        assert aux["deq_fwd_err"] is None
    else:
        np.testing.assert_allclose(_np(aux["deq_fwd_err"]), np.asarray(aux_ref["deq_fwd_err"]),
                                   **TOL)
        assert float(aux["deq_fwd_steps"]) == float(aux_ref["deq_fwd_steps"])
    got = dict(layer.named_parameters())
    for key, g in params_from_jax(jax.tree_util.tree_map(np.asarray, grads)).items():
        np.testing.assert_allclose(got[key].grad.numpy(), g.numpy(), rtol=1e-8,
                                   atol=1e-8 * float(g.abs().max()), err_msg=key)
