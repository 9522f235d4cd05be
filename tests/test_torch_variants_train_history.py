"""The training step of the history variants (history, its joint
state-action output, estpred) and of feedback, the port against the JAX
package in f64 (pendulum, hdim 32, N 2, T 5, H 3, bsz 4): the loss,
loss_end and every parameter gradient against `jax.value_and_grad` of the
JAX step's loss (jitted whole), and the state-estimate losses estpred
logs. A planted fault that must fail: estpred's estimator given the
initial-state row (`state_estimator=False`).

Tolerances as `test_torch_variants_train.py`: rtol 1e-9, and atol 1e-9 of
each gradient tensor's largest entry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deqmpc_tpu_torch.policies import TrackingMPC  # noqa: E402
from torch_variant_pairs import (N, STEP_RTOL, check_step, jax_step_reference,  # noqa: E402
                                 pair, port_step)

torch.set_num_threads(2)

NAMES = ["estpred", "feedback", "history", "history_joint"]


@pytest.fixture(scope="module")
def references():
    """Per variant: the JAX step's reference, computed once."""
    out = {}

    def get(name):
        if name not in out:
            out[name] = jax_step_reference(name)
        return out[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_train_step_loss_and_gradients_match_jax(references, name):
    pol, d = port_step(name)
    ref = references(name)
    check_step(pol, d, ref)
    if name == "estpred":
        np.testing.assert_allclose(d["losses_x_ests"].detach().numpy(),
                                   np.asarray(ref[3]["losses_x_ests"]), rtol=STEP_RTOL, atol=0)
        # the tracking solves' backward, one a round, and the estimator's of
        # every round but the last (whose estimate reaches no loss term)
        assert pol.backward_solves == 2 * N - 1
    else:
        assert pol.backward_solves == N


def test_planted_estimator_with_x0_row_fails_the_step_check(references):
    pol = pair("estpred", seed=8, jit=False)[3]
    cfg = pol.cfg
    pol.state_estimator = TrackingMPC(pol.env, pol.H, al_iter=cfg.al_iter,
                                      state_estimator=False, dtype=cfg.solver_dtype,
                                      rho_max=cfg.rho_max, device="cpu")
    pol, d = port_step("estpred", pol)
    with pytest.raises(AssertionError):
        check_step(pol, d, references("estpred"))
