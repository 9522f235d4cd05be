"""The training step of the delta, mem and Q variants, the port against the
JAX package in f64 (pendulum, hdim 32, N 2, T 5, bsz 4): the loss,
loss_end and every parameter gradient against `jax.value_and_grad` of the
JAX step's loss (jitted whole), and the delta variant's scales after a
whole step (Adam, then the EMA) against optax and `update_scales`.
Planted faults that must fail: the delta's straight-through multiply
replaced by the product rule, and the Q variant's cost scaled without the
+1. Then the train CLI for every variant on the CPU, and the eval CLI on a
variant's port checkpoint. The history variants' steps are in
`test_torch_variants_train_history.py`.

Tolerances: the loss at rtol 1e-9, every gradient at rtol 1e-9 with atol
1e-9 of the tensor's largest entry, as the base step's parity
(`test_torch_train.py`, `test_torch_cartpole_flying_policy.py`); the
scales after the step at 1e-9 (Adam's first step is near -lr sign(g))."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import optax  # noqa: E402

from deqmpc_tpu.models.grad_layers import update_scales as jax_update_scales  # noqa: E402
from deqmpc_tpu_torch.models import deq_layer_variants  # noqa: E402
from deqmpc_tpu_torch.training import eval as port_eval  # noqa: E402
from deqmpc_tpu_torch.training import train  # noqa: E402
from torch_variant_pairs import (H, N, VARIANTS, check_step, jax_step_reference,  # noqa: E402
                                 pair, pendulum_batch, port_step)

torch.set_num_threads(2)

NAMES = ["delta", "mem", "q"]  # the history variants: test_torch_variants_train_history.py


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
    check_step(pol, d, references(name))
    assert pol.backward_solves == N
    if name == "delta":  # one cell application: its iteration embedding gets a gradient
        assert pol.model.iter_emb.grad.abs().max() > 0


def test_delta_scales_after_a_step_match_jax(references):
    """Adam updates the scales with their straight-through gradient, then the
    EMA of the rounds' median errors overwrites them (`train.py:655-664`)."""
    params, jbatch, _, aux, grads = references("delta")
    opt = optax.chain(optax.clip_by_global_norm(2.0), optax.adam(1e-3))
    updates, _ = opt.update(grads, opt.init(params), params)
    stepped = optax.apply_updates(params, updates)
    ref = jax_update_scales(stepped["scales"], list(aux["opt_states"]), jbatch["state"],
                            aux["init_states"])
    pol = pair("delta", seed=8, jit=False)[3]
    before = pol.model.scales.detach().clone()
    train.train_step(pol, train.make_optimizer(pol),
                     train.to_device(pendulum_batch(1), "cpu", torch.float64))
    np.testing.assert_allclose(pol.model.scales.detach().numpy(), np.asarray(ref), rtol=1e-9,
                               atol=1e-9)
    assert (pol.model.scales - before).abs().max() > 1e-3


class _NoPlusOne:
    """The Q variant's planted fault: the tracking cost scaled by Q * q."""

    def __init__(self, tm):
        self.tm = tm

    def __call__(self, *a, q_scaling=None, **kw):
        return self.tm(*a, q_scaling=None if q_scaling is None else q_scaling - 1, **kw)

    def __getattr__(self, name):
        return getattr(self.tm, name)


@pytest.mark.parametrize("name,fault", [("delta", "product_rule"), ("q", "no_plus_one")])
def test_planted_faults_fail_the_step_check(references, monkeypatch, name, fault):
    pol = pair(name, seed=8, jit=False)[3]
    if fault == "product_rule":
        monkeypatch.setattr(deq_layer_variants, "scale_multiply_st", lambda x, s: x * s)
    else:
        pol.tracking_mpc = _NoPlusOne(pol.tracking_mpc)
    pol, d = port_step(name, pol)
    with pytest.raises(AssertionError):
        check_step(pol, d, references(name))


# -- the CLIs ---------------------------------------------------------------------------

CLI = {"mem": ["--addmem"], "delta": ["--policy_variant", "delta"],
       "history": ["--policy_variant", "history", "--H", str(H)],
       "estpred": ["--policy_variant", "estpred", "--H", str(H)],
       "feedback": ["--policy_variant", "feedback", "--layer_type", "mlp"],
       "q": ["--policy_variant", "q"],
       "history_joint": ["--policy_variant", "history", "--H", str(H), "--deq_out_type", "2"]}


@pytest.mark.parametrize("name", sorted(CLI))
def test_train_cli_runs_each_variant(name, tmp_path):
    res = train.main(["--env", "pendulum", "--deq_iter", "2", "--hdim", "16", "--bsz", "4",
                      "--max_train_steps", "2", "--val_every", "2", "--device", "cpu",
                      "--save", "--name", name, "--models_dir", str(tmp_path), *CLI[name]])
    assert res["policy_variant"] == VARIANTS[name][0]
    assert len(res["curve"]) == 1 and np.isfinite(res["curve"][0]["loss_end"])
    if name in ("q", "history"):
        # the eval CLI serves what JAX's eval serves; a history of 3 it refuses
        argv = ["--ckpt", str(tmp_path / name), "--episodes", "2", "--ep_len", "2",
                "--device", "cpu"]
        if name == "q":
            assert port_eval.main(argv)["n_nan_episodes"] == 0
        else:
            with pytest.raises(NotImplementedError, match="estpred and histories"):
                port_eval.main(argv)
