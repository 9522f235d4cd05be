"""The policy variants' forwards, the port against the JAX package in f64:
each of the six policies and History with the joint state-action output
(pendulum, hdim 32, N 2, T 5, H 3, bsz 4; the JAX network call and NewtonAL
solves jitted), the warm tick of the delta and feedback policies (iter
i + 2, clamped), and `build_policy`'s choices and refusals.

Tolerance 1e-7, as the base policy's parity (`test_torch_policy.py`): two
rounds of Anderson and two AL iterations amplify rounding."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.policies import build_policy  # noqa: E402
from torch_variant_pairs import BSZ, H, HDIM, N, T, pair  # noqa: E402

torch.set_num_threads(2)

LAYER_TOL = dict(rtol=1e-7, atol=1e-7)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# -- the policies -----------------------------------------------------------------------

POLICIES = ["mem", "delta", "history", "estpred", "feedback", "q", "history_joint"]


def _policy_inputs(name, env, seed):
    rng = np.random.default_rng(seed)
    h = H if name in ("history", "estpred", "history_joint") else 0
    obs = rng.uniform(-1, 1, size=(BSZ, h, env.nx) if h else (BSZ, env.nx))
    extra = (rng.normal(size=(BSZ, H, env.nu)),) if name == "estpred" else ()
    return obs, extra


@pytest.mark.parametrize("name", POLICIES)
def test_policy_forward_matches_jax(name):
    env, jpol, params, pol = pair(name, seed=5)
    obs, extra = _policy_inputs(name, env, 5)
    ref, ref_carry = jpol.forward(params, jnp.asarray(obs), *map(jnp.asarray, extra))
    with torch.inference_mode():
        out = pol.forward(torch.as_tensor(obs), *map(torch.as_tensor, extra))
    assert len(out["trajs"]) == len(ref["trajs"]) == N
    for i, (got, r) in enumerate(zip(out["trajs"], ref["trajs"])):
        for key, a, b in zip(("x_ref", "x", "u"), got, r):
            np.testing.assert_allclose(_np(a), np.asarray(b), **LAYER_TOL,
                                       err_msg=f"round {i} {key}")
    for key in ("q_scaling", "nominal_x_ests"):
        if key in ref:
            for a, b in zip(jax.tree_util.tree_leaves(ref[key]),
                            jax.tree_util.tree_leaves([list(t) if isinstance(t, tuple) else t
                                                       for t in out[key]])):
                np.testing.assert_allclose(_np(b), np.asarray(a), **LAYER_TOL, err_msg=key)
    if ref_carry is not None:
        np.testing.assert_allclose(_np(out["carry"].solver.lam), np.asarray(ref_carry.solver.lam),
                                   rtol=1e-7, atol=1e-7 * float(np.max(ref_carry.solver.rho)))
    if name == "estpred":  # the estimator ran: every Newton step of its solves retried
        assert pol.newton_retries > 0


@pytest.mark.parametrize("name", ["delta", "feedback"])
def test_warm_tick_matches_jax(name):
    """A warm-started tick (iter i + 2, clamped) from the cold tick's carry."""
    env, jpol, params, pol = pair(name, seed=6)
    obs, _ = _policy_inputs(name, env, 6)
    _, carry = jpol.forward(params, jnp.asarray(obs))
    ref, _ = jpol.forward_warm_start(params, jnp.asarray(obs) * 0.9, carry)
    with torch.inference_mode():
        out = pol.forward(torch.as_tensor(obs))
        out = pol.forward_warm_start(torch.as_tensor(obs) * 0.9, out["carry"])
    for i, (got, r) in enumerate(zip(out["trajs"], ref["trajs"])):
        for key, a, b in zip(("x_ref", "x", "u"), got, r):
            np.testing.assert_allclose(_np(a), np.asarray(b), **LAYER_TOL,
                                       err_msg=f"round {i} {key}")


def test_build_policy_takes_the_variants_and_refuses_what_waits():
    env = make_env("pendulum")
    base = {"T": T, "hdim": HDIM, "deq_iter": N}
    assert type(build_policy({**base, "addmem": True}, env, "cpu")).__name__ == "DEQMPCPolicyMem"
    assert build_policy({**base, "layer_type": "mlp"}, env, "cpu").model.cfg.layer_type == "mlp"
    assert build_policy({**base, "fp_type": "single"}, env, "cpu").model.cfg.fp_type == "single"
    # the slice-8 options build (Qscale and grad_coeff are the env's and the
    # trainer's), a deq_type the JAX CLI does not take is refused
    for key, value in (("fp_type", "multi"), ("fp_type", "broyden"), ("grad_type", "implicit"),
                       ("grad_type", "last_step_grad"), ("recompute_Qq", True)):
        pol = build_policy({**base, key: value}, env, "cpu")
        assert getattr(pol.cfg, key) == value and getattr(pol.model.cfg, key, value) == value
    # inner_deq_iters is taken and dropped, as JAX's build_policy drops it
    pol = build_policy({**base, "fp_type": "multi", "inner_deq_iters": 3}, env, "cpu")
    assert pol.model.cfg.inner_deq_iters == 4 and not hasattr(pol.cfg, "inner_deq_iters")
    assert build_policy({**base, "compute_dtype": "bf16"}, env,
                        "cpu").model.cfg.compute_dtype == torch.bfloat16
    for key, value in (("Qscale", 2.0), ("grad_coeff", True)):
        build_policy({**base, key: value}, env, "cpu")
    with pytest.raises(NotImplementedError, match="deq_type"):
        build_policy({**base, "deq_type": "mlp"}, env, "cpu")
    with pytest.raises(ValueError, match="H >= 2"):
        build_policy({**base, "policy_variant": "estpred", "H": 1}, env, "cpu")
