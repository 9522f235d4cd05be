"""The interior-point path, the port against the JAX package in f64: the
PDIPM (`qp_solve` dense and pre-factored, `qp_solve_single`), the gradients
of all six inputs of `qp_layer` against its `custom_vjp`, `IPMPC.solve` on
the LQ, box, elastic, `eps`-freeze and `lindx` cases with the three
linearisations, and `TrackingMPC(solver_type="ip")` through a policy
forward and a training step.

Tolerances: 1e-8 for the QP and the SQP solve (the same Mehrotra steps;
each dense solve rounds in its own LAPACK, and 18-30 iterations carry it);
1e-8 for the layer's gradients (one more dense solve, at the 1e-10 shift);
1e-7 for the policy forward and rtol 1e-9 (atol 1e-9 x the tensor's
largest entry) for the training step, as the AL path's rows of PERF.md.
A backward that pulls back w in place of -w fails the gradient check."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deqmpc_tpu.envs import PendulumEnv as JaxPendulum  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import DEQMPCPolicy as JaxPolicy  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import PolicyConfig as JaxPolicyConfig  # noqa: E402
from deqmpc_tpu.solvers import LinDx as JaxLinDx  # noqa: E402
from deqmpc_tpu.solvers import QuadCost as JaxQuadCost  # noqa: E402
from deqmpc_tpu.solvers import pdipm as jax_pdipm  # noqa: E402
from deqmpc_tpu.solvers.al_core import lin_dyn_fns  # noqa: E402
from deqmpc_tpu.solvers.ip_mpc import IPMPC as JaxIPMPC  # noqa: E402
from deqmpc_tpu.training import train as jax_train  # noqa: E402
from deqmpc_tpu_torch import data as port_data  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.policies import DEQMPCPolicy, PolicyConfig  # noqa: E402
from deqmpc_tpu_torch.solvers import IPMPC, ALMPC, LinDx, QuadCost, pdipm  # noqa: E402
from deqmpc_tpu_torch.training import train  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import params_from_jax  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-8, atol=1e-8)
POLICY_TOL = dict(rtol=1e-7, atol=1e-7)
QP_NAMES = ("Q", "p", "G", "h", "A", "b")


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), **tol, err_msg=msg)


def _random_qp(seed, nz=6, ni=4, ne=2, bsz=3):
    """A feasible QP per sample, as `tests/test_pdipm.py` draws them."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(bsz, nz, nz))
    Q = L @ np.swapaxes(L, -1, -2) + np.eye(nz) * nz
    p = rng.normal(size=(bsz, nz))
    G = rng.normal(size=(bsz, ni, nz))
    h = rng.normal(size=(bsz, ni)) + 1.0
    A = rng.normal(size=(bsz, ne, nz))
    b = rng.normal(size=(bsz, ne)) * 0.3
    return Q, p, G, h, A, b


# -- the QP solver ----------------------------------------------------------------

@pytest.mark.parametrize("prefactor", [False, True])
@pytest.mark.parametrize("ne", [2, 0])
def test_qp_solve_matches_jax(prefactor, ne):
    qp = _random_qp(0, ne=ne)
    ref = jax_pdipm.qp_solve(*map(jnp.asarray, qp), iters=20, prefactor=prefactor)
    got = pdipm.qp_solve(*map(torch.as_tensor, qp), iters=20, prefactor=prefactor)
    for name in ("z", "s", "lam", "nu", "res"):
        _close(getattr(got, name), getattr(ref, name), TOL, name)
    # converged: the residual is at rounding level
    assert float(got.res.max()) < 1e-8


def test_qp_solve_single_matches_jax():
    Q, p, G, h, A, b = (a[0] for a in _random_qp(3, bsz=1))
    for args in ((Q, p, G, h, A, b), (Q, p, G, h)):
        ref = jax_pdipm.qp_solve_single(*map(jnp.asarray, args))
        got = pdipm.qp_solve_single(*map(torch.as_tensor, args))
        assert got.z.shape == (Q.shape[0],)
        for name in ("z", "s", "lam", "nu"):
            _close(getattr(got, name), getattr(ref, name), TOL, name)


@pytest.fixture(scope="module")
def layer_case():
    """A feasible batch with active inequalities (a point z_f meets the
    equalities and, by a margin of 0.1|N(0,1)|, the inequalities), a
    cotangent, and JAX's six gradients through the custom_vjp. An
    infeasible sample never converges, and its iterate is rounding."""
    Q, p, G, _, A, _ = _random_qp(1, nz=5, ni=4, ne=2, bsz=4)
    rng = np.random.default_rng(11)
    z_f = rng.normal(size=p.shape)
    h = np.einsum("bij,bj->bi", G, z_f) + 0.1 * np.abs(rng.normal(size=(4, 4)))
    qp = [Q, p, G, h, A, np.einsum("bij,bj->bi", A, z_f)]
    gz = np.random.default_rng(2).normal(size=qp[1].shape)
    z, vjp = jax.vjp(lambda *a: jax_pdipm.qp_layer(*a, 25), *map(jnp.asarray, qp))
    return qp, gz, np.asarray(z), [np.asarray(g) for g in vjp(jnp.asarray(gz))]


def _check_layer(case):
    qp, gz, z_ref, grads_ref = case
    t = [torch.as_tensor(a).requires_grad_() for a in qp]
    z = pdipm.qp_layer(*t, 25)
    z.backward(torch.as_tensor(gz))
    _close(z, z_ref, TOL, "z")
    for name, a, g_ref in zip(QP_NAMES, t, grads_ref):
        _close(a.grad, g_ref, TOL, f"d{name}")
    return qp, [a.grad for a in t]


def test_qp_layer_gradients_match_custom_vjp(layer_case):
    counts = dict(pdipm.counts)
    qp, grads = _check_layer(layer_case)
    assert pdipm.counts["backward"] == counts.get("backward", 0) + 1
    # 1 start + 2 per iteration
    assert pdipm.counts["kkt"] == counts.get("kkt", 0) + 1 + 2 * 25
    # rows are active in every sample, and every input gets a gradient
    sol = pdipm.qp_solve(*map(torch.as_tensor, qp), 25)
    assert float(sol.res.max()) < 1e-12 and bool((sol.s < 1e-6).any(dim=1).all())
    assert all(float(g.abs().max()) > 1e-3 for g in grads)


def test_planted_backward_sign_fault_fails_the_layer_check(layer_case, monkeypatch):
    good = pdipm._pull_back
    monkeypatch.setattr(pdipm, "_pull_back", lambda v, sol: good(-v, sol))
    with pytest.raises(AssertionError):
        _check_layer(layer_case)


# -- the SQP solve ------------------------------------------------------------------

def _pendulum_problem(seed, bsz, T):
    """Swing-up tracking cost from seeded start states, both packages'
    dyn_jac, and the port's env."""
    env, jenv = make_env("pendulum"), JaxPendulum()
    rng = np.random.default_rng(seed)
    nx, nu = env.nx, env.nu
    x0 = rng.uniform(-1, 1, (bsz, nx))
    x_ref = np.tile(np.array([np.pi, 0.0]), (bsz, T, 1))
    Qd = np.tile(np.concatenate([env.Qlqr, env.Rlqr]), (bsz, T, 1)).astype(np.float64)
    q = -Qd * np.concatenate([x_ref, np.zeros((bsz, T, nu))], -1)
    return env, jenv, x0, Qd, q


def _jax_dyn_jac(jenv):
    def dyn_jac(x, u):
        xn, (Jx, Ju) = jenv.dynamics_derivatives(x, u)
        return xn, jnp.concatenate([Jx, Ju], -1)
    return dyn_jac


def _port_dyn_jac(env):
    def dyn_jac(x, u):
        xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
        return xn, torch.cat([Jx, Ju], -1)
    return dyn_jac


SQP_CASES = {
    # name: (qp_iter, ipm_iters, extra IPMPC kwargs)
    "box": (3, 25, {}),
    "elastic": (1, 30, dict(elastic=True, elastic_mu=1e4)),
    "autodiff": (3, 25, dict(grad_method="autodiff")),
    "finite_diff": (3, 25, dict(grad_method="finite_diff")),
    "eps_freeze": (4, 25, dict(eps=1e9)),
    "eps_zero": (4, 25, dict(eps=0.0)),
}


@pytest.mark.parametrize("case", sorted(SQP_CASES))
def test_ipmpc_solve_matches_jax(case):
    """The pendulum SQP solve from seeded starts, with the gradient of the
    controls into the cost's linear term q in the box case."""
    qp_iter, ipm_iters, kw = SQP_CASES[case]
    bsz, T = 3, 4
    env, jenv, x0, Qd, q = _pendulum_problem(7, bsz, T)
    box = dict(u_lower=env.action_space.low, u_upper=env.action_space.high)
    analytic = kw.get("grad_method", "analytic") == "analytic"
    jip = JaxIPMPC(env.nx, env.nu, T, **box, dyn=jenv.dynamics,
                   dyn_jac=_jax_dyn_jac(jenv) if analytic else None, qp_iter=qp_iter,
                   ipm_iters=ipm_iters, dtype=jnp.float64, **kw)
    ip = IPMPC(env.nx, env.nu, T, **box, dyn=env.dynamics,
               dyn_jac=_port_dyn_jac(env) if analytic else None, qp_iter=qp_iter,
               ipm_iters=ipm_iters, dtype=torch.float64, device="cpu", **kw)
    g = np.random.default_rng(1).normal(size=(bsz, T, env.nu))

    def jax_u(q_):
        return jip.solve(jnp.asarray(x0), JaxQuadCost(Q=jnp.asarray(Qd), q=q_,
                                                      f=jnp.zeros((bsz, T))))

    (x_ref, u_ref), vjp = jax.vjp(jax_u, jnp.asarray(q))
    qt = torch.as_tensor(q).requires_grad_()
    x, u = ip.solve(torch.as_tensor(x0), QuadCost(Q=torch.as_tensor(Qd), q=qt,
                                                  f=torch.zeros(bsz, T, dtype=torch.float64)))
    _close(x, x_ref, TOL, "x")
    _close(u, u_ref, TOL, "u")
    assert float(u.detach().abs().max()) <= env.max_torque + 1e-6
    if case == "box":
        u.backward(torch.as_tensor(g))
        dq_ref = vjp((jnp.zeros_like(x_ref), jnp.asarray(g)))[0]
        _close(qt.grad, dq_ref, TOL, "dq")
        assert float(qt.grad.abs().max()) > 1e-4


def test_ipmpc_lq_with_lindx_matches_jax_and_the_al_solve():
    """A linear model (`lindx`) with an inactive box: the SQP solve
    against JAX's, and both against the port's AL solve of the same LQ."""
    rng = np.random.default_rng(42)
    bsz, T, nx, nu = 2, 4, 3, 2
    F = np.concatenate([0.5 * rng.normal(size=(bsz, T - 1, nx, nx)),
                        0.5 * rng.normal(size=(bsz, T - 1, nx, nu))], axis=-1)
    f = 0.1 * rng.normal(size=(bsz, T - 1, nx))
    Qd = rng.uniform(0.5, 2.0, size=(bsz, T, nx + nu))
    q = rng.normal(size=(bsz, T, nx + nu))
    x0 = rng.normal(size=(bsz, nx))
    box = dict(u_lower=-1e3 * np.ones(nu), u_upper=1e3 * np.ones(nu))
    jlin = JaxLinDx(F=jnp.asarray(F), f=jnp.asarray(f))
    jdyn, jdyn_jac = lin_dyn_fns(jlin)
    jip = JaxIPMPC(nx, nu, T, **box, dyn=jdyn, dyn_jac=jdyn_jac, lindx=jlin, qp_iter=1,
                   ipm_iters=30, dtype=jnp.float64)
    x_ref, u_ref = jip.solve(jnp.asarray(x0), JaxQuadCost(Q=jnp.asarray(Qd), q=jnp.asarray(q),
                                                          f=jnp.zeros((bsz, T))))
    lin = LinDx(F=torch.as_tensor(F), f=torch.as_tensor(f))
    dyn, dyn_jac = ALMPC.linear_dynamics(lin)
    ip = IPMPC(nx, nu, T, **box, dyn=dyn, dyn_jac=dyn_jac, lindx=lin, qp_iter=1, ipm_iters=30,
               dtype=torch.float64, device="cpu")
    cost = QuadCost(Q=torch.as_tensor(Qd), q=torch.as_tensor(q),
                    f=torch.zeros(bsz, T, dtype=torch.float64))
    x, u = ip.solve(torch.as_tensor(x0), cost)
    _close(x, x_ref, TOL, "x")
    _close(u, u_ref, TOL, "u")
    al = ALMPC(nx, nu, T, **box, dyn=dyn, dyn_jac=dyn_jac, dtype=torch.float64, device="cpu")
    x_al, u_al, _, _ = al.solve(torch.as_tensor(x0), cost, al.init_state(bsz), al_iter=8)
    _close(x, x_al, dict(rtol=1e-4, atol=1e-5), "x vs AL")
    _close(u, u_al, dict(rtol=1e-4, atol=1e-5), "u vs AL")


def test_ipmpc_eps_freeze_keeps_the_first_iterate():
    """With a huge eps every sample freezes after the first SQP iteration,
    so qp_iter 4 and 2 agree (`qp_wrapper.py:173,377`)."""
    bsz, T = 3, 4
    env, _, x0, Qd, q = _pendulum_problem(11, bsz, T)
    cost = QuadCost(*(torch.as_tensor(a) for a in (Qd, q, np.zeros((bsz, T)))))
    kw = dict(u_lower=env.action_space.low, u_upper=env.action_space.high, dyn=env.dynamics,
              dyn_jac=_port_dyn_jac(env), ipm_iters=25, dtype=torch.float64, device="cpu",
              eps=1e9)
    _, u_a = IPMPC(env.nx, env.nu, T, qp_iter=4, **kw).solve(torch.as_tensor(x0), cost)
    _, u_b = IPMPC(env.nx, env.nu, T, qp_iter=2, **kw).solve(torch.as_tensor(x0), cost)
    _close(u_a, u_b, dict(rtol=1e-12, atol=1e-14))


# -- the policy with the interior-point tracking solve ------------------------------

HDIM, N, BSZ, T_H = 32, 2, 4, 5


def _ip_policies(seed):
    env = make_env("pendulum")
    kw = dict(nx=env.nx, nu=env.nu, nq=1, T=T_H, dt=env.dt, hdim=HDIM, deq_iter=N,
              rho_max=1e5, solver_type="ip")
    jpol = JaxPolicy(JaxPolicyConfig(**kw, solver_dtype=jnp.float64), JaxPendulum())
    params = jpol.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64) + 0.05 * rng.normal(size=a.shape)),
        params)
    pol = DEQMPCPolicy(PolicyConfig(**kw, solver_dtype=torch.float64), env, device="cpu")
    pol.model.double()
    pol.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return env, jpol, params, pol


def test_ip_policy_forward_matches_jax():
    env, jpol, params, pol = _ip_policies(seed=3)
    assert pol.tracking_mpc.solver_type == "ip"
    obs = env.reset(torch.Generator().manual_seed(1), BSZ, device="cpu", dtype=torch.float64)
    ref, ref_carry = jax.jit(jpol.forward)(params, jnp.asarray(obs.numpy()))
    kkt0 = pdipm.counts["kkt"]
    with torch.inference_mode():
        out = pol.forward(obs)
    # one SQP solve of 18 interior-point iterations a round, no AL solve
    assert pdipm.counts["kkt"] - kkt0 == N * (1 + 2 * 18)
    assert pol.newton_steps == 0
    for i, (got, r) in enumerate(zip(out["trajs"], ref["trajs"])):
        for name, a, b in zip(("x_ref", "x", "u"), got, r):
            _close(a, b, POLICY_TOL, f"round {i} {name}")
    assert not out["status"].any() and not np.asarray(ref["status"]).any()
    # as in JAX, the SQP line search starts from the network's reference,
    # where the tracking cost is least: no step lowers it, every sample
    # takes the smallest, 0.2^9, and the plan stays within 0.2^9 of the QP
    # step from the reference (the network's controls are 0)
    u = out["trajs"][-1][2]
    assert float(u.abs().max()) <= 0.2 ** 9 * env.max_torque * (1 + 1e-9)
    # the AL state is handed back unchanged
    assert not out["carry"].solver.lam.any() and not out["carry"].solver.has_init.any()


def test_ip_train_step_loss_and_gradients_match_jax():
    env, jpol, params, pol = _ip_policies(seed=5)
    gt, _ = train.split_episodes(port_data.get_gt_data(env)[:40])
    batch = train.preprocess_batch("pendulum", env.nx, port_data.sample_trajectory(
        gt, BSZ, 1, T_H, np.random.default_rng(11)))
    opt = optax.chain(optax.clip_by_global_norm(2.0), optax.adam(1e-3))
    _, loss_fn = jax_train.make_train_step(
        jpol, opt, types.SimpleNamespace(qp_solve=True, lastqp_solve=False))
    jbatch = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in batch.items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jbatch, jnp.ones((N, 3)))
    back0 = pdipm.counts["backward"]
    d = train.loss_fn(pol, train.to_device(batch, "cpu", torch.float64))
    d["loss"].backward()
    assert pdipm.counts["backward"] - back0 == N  # one qp_layer backward a round
    _close(d["loss"], loss, dict(rtol=1e-9, atol=1e-11), "loss")
    _close(d["loss_end"], aux["loss_end"], dict(rtol=1e-9, atol=1e-11), "loss_end")
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    got = dict(pol.model.named_parameters())
    for name, g_ref in ref.items():
        if name == "iter_emb":
            assert got[name].grad is None and not g_ref.numpy().any()
            continue
        tol = dict(rtol=1e-9, atol=1e-9 * float(g_ref.abs().max()))
        _close(got[name].grad, g_ref, tol, name)
    assert np.abs(_np(got["out.Conv_1.kernel"].grad)).max() > 1e-4
