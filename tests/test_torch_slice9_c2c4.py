"""Two unchecked comparisons with the JAX package, settled on the same
systems (f32, the checkpoints at full width, CPU):

- the retry rate (ROADMAP C2): every Newton system the port's tick 0
  assembles for `rexquad_deqmpc` and `flying_deqmpc_nn` goes to JAX's
  block-tridiagonal solves, the XLA one (JAX's CPU path) and the Pallas
  kernel in interpret mode (its TPU path). JAX retries a system when its
  solve has a non-finite entry anywhere in the batch, as the port does;
  the port's `NewtonAL.retries` is held against that count;
- the zeroed share of the implicit backward (ROADMAP C4): every backward
  system (D, O, g_out) of a config-#4 f32 training step goes to JAX's
  `newton_bwd` solve; a sample whose dx has a non-finite entry gets no
  gradient in either package.

Most of these systems are indefinite or nearly singular, so which samples
come back non-finite turns on f32 rounding: JAX's own two solves disagree
on some. Each count of the port (systems retried, samples non-finite) is
held within that spread of JAX's: the systems within the two solves'
difference (at least one), the samples within twice their disagreement.
Slow: the port's full-width f32 forward and step on the CPU, and JAX's
compiles of the interpret-mode kernel."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.ops.pallas_tridiag import pallas_block_tridiag_solve  # noqa: E402
from deqmpc_tpu.ops.tridiag import block_tridiag_solve as jax_xla_solve  # noqa: E402
from deqmpc_tpu_torch import data as port_data  # noqa: E402
from deqmpc_tpu_torch.envs import make_env_of  # noqa: E402
from deqmpc_tpu_torch.ops import tridiag  # noqa: E402
from deqmpc_tpu_torch.policies import build_policy  # noqa: E402
from deqmpc_tpu_torch.solvers import newton_al  # noqa: E402
from deqmpc_tpu_torch.training import train  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402

torch.set_num_threads(4)

STATES = 16  # tick-0 start states
BSZ = 16     # the training step's batch


def _policy(ckpt):
    state, args = load_checkpoint(f"checkpoints/{ckpt}", "cpu")
    env = make_env_of(args)
    pol = build_policy(args, env, "cpu", obstacles=train.build_obstacles(env))
    pol.model.load_state_dict(state)
    assert pol.cfg.solver_dtype == torch.float32
    return args, env, pol


JAX_SOLVES = {"xla": jax.jit(jax_xla_solve),
              "pallas": jax.jit(functools.partial(pallas_block_tridiag_solve, interpret=True))}


def _jax_bad(systems):
    """Per system and sample, whether each JAX solve has a non-finite entry:
    {solve: [bool (bsz,) per system]}. The samples are independent, so all
    systems go through each solve as one batch (one compile a shape)."""
    bsz = systems[0][0].shape[0]
    D, O, b = (jnp.asarray(torch.cat([s[k] for s in systems]).numpy()) for k in range(3))
    out = {}
    for name, solve in JAX_SOLVES.items():
        bad = ~np.isfinite(np.asarray(solve(D, O, b))).reshape(D.shape[0], -1).all(axis=1)
        out[name] = [bad[i * bsz:(i + 1) * bsz] for i in range(len(systems))]
    return out


def _port_bad(D, O, b):
    x = tridiag.block_tridiag_solve(D, O, b)
    return ~torch.isfinite(x).flatten(1).all(dim=1).numpy()


def _compare(what, port_bad, systems):
    """The port's per-sample NaN flags against each JAX solve's on the same
    systems: the systems each would retry (a non-finite entry anywhere in
    the batch) and the samples they disagree on, each held within JAX's own
    spread, the distance between its XLA and Pallas solves (at least one
    system, and twice the samples). Returns the counts."""
    jax_bad = _jax_bad(systems)
    n = sum(len(b) for b in port_bad)

    def retried(bad):
        return sum(bool(b.any()) for b in bad)

    def differ(a, b):
        return sum(int((x != y).sum()) for x, y in zip(a, b))

    spread_sys = abs(retried(jax_bad["xla"]) - retried(jax_bad["pallas"]))
    spread = differ(jax_bad["xla"], jax_bad["pallas"])
    counts = {"systems": len(systems), "samples": n, "port_retried": retried(port_bad),
              "port_nonfinite": int(sum(b.sum() for b in port_bad)),
              "xla_vs_pallas_samples": spread}
    for name, bad in jax_bad.items():
        counts[f"{name}_retried"] = retried(bad)
        counts[f"{name}_nonfinite"] = int(sum(b.sum() for b in bad))
        counts[f"port_vs_{name}_samples"] = differ(port_bad, bad)
    print(what, counts)
    for name, bad in jax_bad.items():
        assert abs(retried(port_bad) - retried(bad)) <= max(spread_sys, 1), counts
        assert differ(port_bad, bad) <= 2 * spread, counts
    return counts


@pytest.mark.slow
@pytest.mark.parametrize("ckpt", ["rexquad_deqmpc", "flying_deqmpc_nn"])
def test_retry_rate_matches_jax_on_the_same_systems(ckpt):
    args, env, pol = _policy(ckpt)
    newton = pol.tracking_mpc.ctrl.newton
    systems, solve = [], newton._solve_newton_system

    def record(g, D, O):
        systems.append((D.clone(), O.clone(), g.clone()))
        return solve(g, D, O)

    newton._solve_newton_system = record
    x = env.reset(torch.Generator().manual_seed(3), STATES, device="cpu")
    with torch.inference_mode():
        pol.forward(x)
    port_bad = [_port_bad(*s) for s in systems]
    # the counter counts the systems whose first solve has a NaN
    assert pol.newton_retries == sum(bool(b.any()) for b in port_bad)
    _compare(f"{ckpt} tick 0", port_bad, systems)


@pytest.mark.slow
def test_backward_zeroed_share_matches_jax_on_the_same_systems(monkeypatch):
    """A config-#4 f32 training step: the port's zeroed samples against
    the samples JAX's `newton_bwd` solve leaves non-finite."""
    args, env, pol = _policy("rexquad_deqmpc")
    recorded, grads = [], newton_al.implicit_grads

    def record(D, O, xu_out, g_out):
        recorded.append((D.clone(), O.clone(), g_out.clone()))
        return grads(D, O, xu_out, g_out)

    monkeypatch.setattr(newton_al, "implicit_grads", record)
    gt, _ = train.split_episodes(port_data.get_gt_data(env, "mpc"))
    batch = train.preprocess_batch(args["env"], env.nx, port_data.sample_trajectory(
        gt, BSZ, 1, args["T"], np.random.default_rng(0)))
    d = train.loss_fn(pol, train.to_device(batch, "cpu"))
    d["loss"].backward()
    assert len(recorded) == pol.backward_solves == args["deq_iter"]
    port_bad = [_port_bad(*s) for s in recorded]
    assert int(pol.tracking_mpc.ctrl.newton.backward_zeroed) == sum(b.sum() for b in port_bad)
    _compare("config-#4 step backward", port_bad, recorded)
