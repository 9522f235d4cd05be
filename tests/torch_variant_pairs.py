"""Pairs of policies of the variant family for the parity tests: the JAX
package's (f64 solver, its network call and NewtonAL solves jitted) and
the port's, loaded with the same perturbed f64 parameters; the pendulum
batch they are held on; the JAX training step's reference, the port's
step, and the check between them. `opts`, (key, value) pairs of the
fixed point and the cost refresh (`fp_type`, `grad_type`, `recompute_Qq`),
go to both policies' configs. Imported by `test_torch_variants*.py` and
`test_torch_slice8_train.py`."""
import functools
import types

import numpy as np
import torch

import jax
import jax.numpy as jnp

from deqmpc_tpu.envs import PendulumEnv as JaxPendulum
from deqmpc_tpu.policies import policy_variants as jax_pv
from deqmpc_tpu.policies.deqmpc_policy import DEQMPCPolicy as JaxPolicy
from deqmpc_tpu.policies.deqmpc_policy import PolicyConfig as JaxPolicyConfig
from deqmpc_tpu.training import train as jax_train
from deqmpc_tpu_torch import data as port_data
from deqmpc_tpu_torch.envs import make_env
from deqmpc_tpu_torch.policies import build_policy
from deqmpc_tpu_torch.training import train
from deqmpc_tpu_torch.utils.checkpoint import params_from_jax

HDIM, N, T, H, BSZ = 32, 2, 5, 3, 4
# variant name -> (policy_variant, H, deq_out_type, layer_type)
VARIANTS = {"mem": ("mem", 1, 1, "gcn"), "delta": ("delta", 1, 1, "gcn"),
            "history": ("history", H, 1, "gcn"), "estpred": ("estpred", H, 1, "gcn"),
            "feedback": ("feedback", 1, 1, "gcn"), "q": ("q", 1, 1, "gcn"),
            "history_joint": ("history", H, 2, "gcn"), "base": ("base", 1, 1, "gcn")}
JAX_CLASSES = {"base": JaxPolicy, "mem": jax_pv.DEQMPCPolicyMem, "delta": jax_pv.DEQMPCPolicyDelta,
               "history": jax_pv.DEQMPCPolicyHistory,
               "estpred": jax_pv.DEQMPCPolicyHistoryEstPred,
               "feedback": jax_pv.DEQMPCPolicyFeedback, "q": jax_pv.DEQMPCPolicyQ}


class Jitted:
    """A JAX module whose __call__ is jitted once."""

    def __init__(self, module):
        self._module, self._call = module, jax.jit(module.__call__)

    def __call__(self, *args):
        return self._call(*args)

    def __getattr__(self, name):
        return getattr(self._module, name)


def jit_pieces(jpol):
    """Jit the JAX policy's network call and its NewtonAL solves (the
    estimator's too), each once."""
    jpol.model = Jitted(jpol.model)
    ctrls = [jpol.tracking_mpc.ctrl]
    if hasattr(jpol, "state_estimator"):
        ctrls.append(jpol.state_estimator.ctrl)
    for ctrl in ctrls:
        ctrl._newton = jax.jit(ctrl._newton)
    return jpol


def args_of(name, **kw):
    variant, h, out_type, layer_type = VARIANTS[name]
    return {"env": "pendulum", "T": T, "nq": 1, "hdim": HDIM, "deq_iter": N,
            "policy_variant": variant, "H": h, "deq_out_type": out_type,
            "layer_type": layer_type, "rho_max": 1e5, **kw}


@functools.lru_cache(maxsize=None)
def _jax_side(name, seed, jit, opts=()):
    """The JAX policy and its perturbed f64 parameters, made once."""
    env = make_env("pendulum")
    cfg = build_policy(args_of(name), env, "cpu").cfg
    jcfg = JaxPolicyConfig(nx=env.nx, nu=env.nu, nq=cfg.nq, T=T, dt=env.dt, hdim=HDIM,
                           layer_type=cfg.layer_type, deq_iter=N,
                           deq_out_type=cfg.deq_out_type, rho_max=cfg.rho_max,
                           solver_dtype=jnp.float64, **dict(opts))
    variant, h = VARIANTS[name][:2]
    cls = JAX_CLASSES[variant]
    jpol = cls(jcfg, JaxPendulum(), H=h) if variant in ("history", "estpred") else cls(
        jcfg, JaxPendulum())
    params = jpol.init(jax.random.PRNGKey(seed))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(np.asarray(leaf, np.float64) + 0.05 * rng.normal(size=leaf.shape))
        for leaf in leaves])
    return jit_pieces(jpol) if jit else jpol, params


def pair(name, seed, jit=True, opts=()):
    """(env, JAX policy, f64 params, a fresh port policy in f64 with them)."""
    env = make_env("pendulum")
    args = args_of(name, **dict(opts))
    jpol, params = _jax_side(name, seed, jit, opts)
    pol = build_policy({**args, "dtype": "double", "rho_max": 1e5}, env, "cpu")
    pol.model.double()  # before loading: the f64 params must not pass through f32
    pol.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    assert pol.cfg.solver_dtype == torch.float64 and pol.cfg.rho_max == 1e5
    return env, jpol, params, pol


def pendulum_batch(H_, seed=11):
    """A seeded bsz-4 batch of expert windows through the port's pipeline."""
    env = make_env("pendulum")
    gt, _ = train.split_episodes(port_data.get_gt_data(env, "mpc")[:40])
    batch = port_data.sample_trajectory(gt, BSZ, H_, T, np.random.default_rng(seed))
    return train.preprocess_batch("pendulum", env.nx, batch)


STEP_RTOL = 1e-9


def jax_step_reference(name, opts=(), moves=()):
    """The JAX step's loss, aux and gradients on the variant's batch, with
    the pair's parameters: (params, batch, loss, aux, grads). Jitted whole:
    it compiles faster than the pieces run eagerly. For each relative size
    in `moves`, the same step from observations moved by it (seeded) is
    appended: (grads of each moved step)."""
    _, jpol, params, _ = pair(name, seed=8, jit=False, opts=opts)
    _, loss_fn = jax_train.make_train_step(
        jpol, None, types.SimpleNamespace(qp_solve=True, lastqp_solve=False))
    jbatch = {k: jnp.asarray(np.asarray(v, np.float64))
              for k, v in pendulum_batch(VARIANTS[name][1]).items()}
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, aux), grads = step(params, jbatch, jnp.ones((N, 3)))
    out = (params, jbatch, loss, aux, grads)
    rng = np.random.default_rng(1)
    for rel in moves:
        noise = 1 + rel * rng.normal(size=jbatch["obs"].shape)
        out += (step(params, {**jbatch, "obs": jbatch["obs"] * noise}, jnp.ones((N, 3)))[1],)
    return out


def port_step(name, pol=None, opts=()):
    """The port's loss dict on the same batch, after its backward."""
    if pol is None:
        pol = pair(name, seed=8, jit=False, opts=opts)[3]
    d = train.loss_fn(pol, train.to_device(pendulum_batch(VARIANTS[name][1]), "cpu",
                                           torch.float64))
    d["loss"].backward()
    return pol, d


def check_step(pol, d, ref, grad_rel=None):
    """Loss and loss_end at rtol STEP_RTOL; every gradient at rtol STEP_RTOL
    and atol STEP_RTOL of the tensor's largest entry, or `grad_rel[key]` of
    it where given (a parameter the forward does not read has no torch
    gradient and a zero JAX one)."""
    _, _, loss, aux, grads = ref
    for key, a, b in (("loss", d["loss"], loss), ("loss_end", d["loss_end"], aux["loss_end"])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=STEP_RTOL, atol=0,
                                   err_msg=key)
    g_ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    got = dict(pol.model.named_parameters())
    assert set(g_ref) == set(got)
    for key, g in g_ref.items():
        if got[key].grad is None:
            assert not g.numpy().any(), key
            continue
        rel = STEP_RTOL if grad_rel is None else max(STEP_RTOL, grad_rel[key])
        tol = dict(rtol=STEP_RTOL, atol=rel * float(g.abs().max()))
        np.testing.assert_allclose(got[key].grad.numpy(), g.numpy(), **tol, err_msg=key)
