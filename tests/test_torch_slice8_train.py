"""Training with the fixed-point family, the cost refresh and the
gradient-ratio coefficients, the port against the JAX package in f64: the
train step's loss and every parameter gradient against `jax.value_and_grad`
(jitted whole) under `grad_type` "implicit" (Anderson and Broyden),
`recompute_Qq` (base and mem), and `fp_type` "multi" with the last-step
gradient (pendulum, hdim 32, N 2, T 5, bsz 4), with the rounds' solver
stats; `compute_grad_ratio_coeffs` and `update_coeffs_ema` against JAX's;
and the env's Q under `Qscale`. The CLIs and the bf16 trunk are in
`test_torch_slice8_cli.py`.

Tolerances: the step at rtol 1e-9 (loss) and rtol 1e-9, atol 1e-9 of the
largest entry (gradients), as the base step's parity, but for Anderson's
implicit step, held within 10x JAX's own move under a 1e-14 move of the
observations (see its test); the ratios and the coefficients at 1e-8."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.envs import FlyingCartpole as JaxFlyingCartpole  # noqa: E402
from deqmpc_tpu.training import grad_coeffs as jax_grad_coeffs  # noqa: E402
from deqmpc_tpu_torch.envs import make_env, make_env_of  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import params_from_jax  # noqa: E402
from deqmpc_tpu_torch.training import grad_coeffs, train  # noqa: E402
from torch_variant_pairs import (N, check_step, jax_step_reference, pair,  # noqa: E402
                                 pendulum_batch, port_step)

torch.set_num_threads(2)

STEPS = {
    "implicit_anderson": ("base", (("grad_type", "implicit"),)),
    "implicit_broyden": ("base", (("fp_type", "broyden"), ("grad_type", "implicit"))),
    "recompute": ("base", (("recompute_Qq", True),)),
    "multi_last_step": ("base", (("fp_type", "multi"), ("grad_type", "last_step_grad"))),
    "mem_recompute": ("mem", (("recompute_Qq", True),)),
}


def _relative_moves(grads, moved):
    """Per parameter, |moved - grads| over the largest |grads| entry."""
    g0 = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    g1 = params_from_jax(jax.tree_util.tree_map(np.asarray, moved))
    return {k: float((g1[k] - g).abs().max() / max(float(g.abs().max()), 1e-300))
            for k, g in g0.items()}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_train_step_loss_and_gradients_match_jax(case):
    """The loss and every case's gradients at 1e-9, but for Anderson's
    implicit backward: its transpose solve (w = J'w + g by Anderson, a
    nearly singular mixing system) turns rounding into gradient moves, in
    JAX as in the port. JAX's own gradients move by up to 8.9e-5 of their
    largest entry when the observations move by 1e-14, and the port's sit
    1.3e-4 from JAX's (measured); that case holds the port within 10x JAX's
    own move, which must exceed 1e-7 somewhere (the behaviour is JAX's) and
    stay under 1e-3."""
    name, opts = STEPS[case]
    anderson_implicit = case == "implicit_anderson"
    ref = jax_step_reference(name, opts, moves=(1e-14,) if anderson_implicit else ())
    grad_rel = None
    if anderson_implicit:
        jax_move = _relative_moves(ref[4], ref[5])
        assert 1e-7 < max(jax_move.values()) < 1e-3
        grad_rel = {k: 10 * v for k, v in jax_move.items()}
    pol, d = port_step(name, opts=opts)
    check_step(pol, d, ref[:5], grad_rel)
    aux = ref[3]
    if "deq_fwd_err" in aux:  # the rounds' solver stats ride along
        np.testing.assert_allclose(d["deq_stats"]["fwd_err"].numpy(),
                                   np.asarray(aux["deq_fwd_err"]), rtol=1e-8)
    else:
        assert "deq_stats" not in d
    # under the refresh no round's solve takes a gradient; else one a round
    assert pol.backward_solves == (0 if "recompute" in case else N)


# -- the gradient-ratio coefficients -----------------------------------------------------

def test_grad_ratio_coeffs_and_ema_match_jax():
    _, jpol, params, pol = pair("base", seed=9, jit=False)
    batch = pendulum_batch(1)
    jbatch = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in batch.items()}
    ratios_ref, lo_ref, ln_ref = jax.jit(
        lambda p, b: jax_grad_coeffs.compute_grad_ratio_coeffs(jpol, p, b))(params, jbatch)
    ratios, lo, ln = grad_coeffs.compute_grad_ratio_coeffs(
        pol, train.to_device(batch, "cpu", torch.float64))
    np.testing.assert_allclose(lo.numpy(), np.asarray(lo_ref), rtol=1e-9)
    np.testing.assert_allclose(ln.numpy(), np.asarray(ln_ref), rtol=1e-9)
    np.testing.assert_allclose(ratios.numpy(), np.asarray(ratios_ref), rtol=1e-8)
    # round j's probe runs the backwards of rounds 0..j
    assert pol.backward_solves == N * (N + 1) // 2
    coeffs = np.ones((N, 3)) * np.array([[1.0], [0.7]])
    np.testing.assert_allclose(
        grad_coeffs.update_coeffs_ema(torch.as_tensor(coeffs), ratios).numpy(),
        np.asarray(jax_grad_coeffs.update_coeffs_ema(jnp.asarray(coeffs), ratios_ref)),
        rtol=1e-8)
    assert grad_coeffs.out_head(pol.model) is pol.model.out


# -- the env ---------------------------------------------------------------------------------

def test_env_q_under_qscale():
    """The FlyingCartpole's velocity weights scale, as JAX's; other envs
    take no Qscale."""
    for qscale in (1.0, 2.0):
        env = make_env_of({"env": "FlyingCartpole", "Qscale": qscale})
        np.testing.assert_array_equal(env.Qlqr, np.asarray(JaxFlyingCartpole(Qscale=qscale).Qlqr))
        assert env.Qlqr[7:].tolist() == [qscale] * 7 and env.Qlqr[:7].tolist()[-1] == 80.0
    assert make_env_of({"env": "pendulum", "Qscale": 2.0}).Qlqr.tolist() == \
        make_env("pendulum").Qlqr.tolist()
