"""The port's training path against the JAX package in f64: the NewtonAL
autograd Function against the `custom_vjp`, a whole pendulum training step
(loss and every parameter gradient) against `jax.value_and_grad`, the
clipped Adam update against optax, and the data pipeline and losses
against their JAX twins; then the train CLI and its checkpoint on the CPU.

Tolerances: 1e-8 for the Function (rounding through at most 4 Newton
steps and one solve, as the forward's parity in `test_torch_al.py`);
rtol 1e-9 for the whole step (two rounds of 2 AL iterations; the gap is
about 5e-14 relative, and a forward from parameters rounded to f32 misses
it by 1e-7); 1e-12 for the optimizer update; exact for the data
pipeline."""
import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deqmpc_tpu import utils as jax_utils  # noqa: E402
from deqmpc_tpu.data import datagen as jax_datagen  # noqa: E402
from deqmpc_tpu.envs import PendulumEnv as JaxPendulum  # noqa: E402
from deqmpc_tpu.envs import RexQuadrotor as JaxQuad  # noqa: E402
from deqmpc_tpu.policies import losses as jax_losses  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import DEQMPCPolicy as JaxPolicy  # noqa: E402
from deqmpc_tpu.policies.deqmpc_policy import PolicyConfig as JaxPolicyConfig  # noqa: E402
from deqmpc_tpu.solvers.newton_al import NewtonALConfig as JaxNewtonALConfig  # noqa: E402
from deqmpc_tpu.solvers.newton_al import make_newton_al  # noqa: E402
from deqmpc_tpu.training import train as jax_train  # noqa: E402
from deqmpc_tpu_torch import data as port_data  # noqa: E402
from deqmpc_tpu_torch.data import datagen as port_datagen  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.policies import DEQMPCPolicy, PolicyConfig, losses  # noqa: E402
from deqmpc_tpu_torch.solvers import NewtonAL, NewtonALConfig, newton_al  # noqa: E402
from deqmpc_tpu_torch.training import eval as port_eval  # noqa: E402
from deqmpc_tpu_torch.training import train  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import params_from_jax, read_port_checkpoint  # noqa: E402

torch.set_num_threads(2)

FN_TOL = dict(rtol=1e-8, atol=1e-8)
STEP_TOL = dict(rtol=1e-9, atol=1e-11)
ARGS = ("xu", "x0", "lam", "rho", "Q", "q")
JAX_ENVS = {"pendulum": JaxPendulum, "rexquadrotor": JaxQuad}


# -- the NewtonAL Function against the custom_vjp --------------------------------

def _newton_problem(env, seed, bsz=5, T=5, indefinite=False):
    """A NewtonAL problem in f64: the first two samples keep the controls
    inside the box, the rest push them through it; with `indefinite`, the
    last sample's cost is negative on a control, so its Hessian is not
    positive definite and its implicit backward comes back NaN."""
    nx, nu = env.nx, env.nu
    lo, hi = env.action_space.low.astype(np.float64), env.action_space.high.astype(np.float64)
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.normal(size=(bsz, T, nx))
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    spread = np.where(np.arange(bsz) < 2, 0.5, 1.5)[:, None, None]
    u = mid + spread * half * rng.uniform(-1, 1, size=(bsz, T, nu))
    xu = np.concatenate([x, u], axis=-1)
    Q = np.broadcast_to(np.concatenate([env.Qlqr, np.full(nu, 0.1)]), xu.shape).copy()
    if indefinite:
        Q[-1, :, nx] = -1e3
    q = -Q * (xu + 0.2 * rng.normal(size=xu.shape))
    x0 = x[:, 0] + 0.1 * rng.normal(size=(bsz, nx))
    ncon = T * nx + 2 * nu * T
    lam = 0.1 * rng.normal(size=(bsz, ncon))
    lam[:, T * nx:] = np.abs(lam[:, T * nx:])
    rho = np.full((bsz, 1), 10.0)
    return dict(xu=xu, x0=x0, lam=lam, rho=rho, Q=Q, q=q), (lo, hi)


def _jax_newton_vjp(env_name, p, box, g):
    jenv = JAX_ENVS[env_name]()

    def dyn_jac(x, u):
        xn, (Jx, Ju) = jenv.dynamics_derivatives(x, u)
        return xn, jnp.concatenate([Jx, Ju], axis=-1)

    nx, nu = jenv.nx, jenv.nu
    T = p["xu"].shape[1]
    newton = make_newton_al(JaxNewtonALConfig(nx=nx, nu=nu, T=T, tridiag_backend="xla"),
                            jenv.dynamics, dyn_jac, *(jnp.asarray(b) for b in box))
    J = {k: jnp.asarray(v) for k, v in p.items()}
    out, vjp = jax.vjp(lambda Q, q: newton(J["xu"], J["x0"], J["lam"], J["rho"], Q, q)[0],
                       J["Q"], J["q"])
    dQ, dq = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dQ), np.asarray(dq)


def _port_newton_vjp(env, p, box, g):
    def dyn_jac(x, u):
        xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
        return xn, torch.cat([Jx, Ju], dim=-1)

    T = p["xu"].shape[1]
    newton = NewtonAL(NewtonALConfig(nx=env.nx, nu=env.nu, T=T), env.dynamics, dyn_jac,
                      *(torch.as_tensor(b) for b in box))
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    Q, q = t["Q"].requires_grad_(), t["q"].requires_grad_()
    out, status = newton(t["xu"], t["x0"], t["lam"], t["rho"], Q, q)
    out.backward(torch.as_tensor(g))
    assert newton.backward_solves == 1 and 1 <= newton.steps <= 4
    assert newton.backward_samples == len(p["xu"])
    assert not status.requires_grad
    return out.detach().numpy(), Q.grad.numpy(), q.grad.numpy(), int(newton.backward_zeroed)


@pytest.fixture(scope="module")
def newton_cases():
    """(port problem, JAX reference) per case, computed once."""
    cases = {}
    for name, env_name, indefinite in (("pendulum", "pendulum", False),
                                       ("rexquadrotor", "rexquadrotor", False),
                                       ("rexquadrotor_indefinite", "rexquadrotor", True)):
        env = make_env(env_name)
        p, box = _newton_problem(env, seed=len(cases), indefinite=indefinite)
        g = np.random.default_rng(7).normal(size=p["xu"].shape)
        cases[name] = (env, p, box, g, _jax_newton_vjp(env_name, p, box, g))
    return cases


def _check_function(case):
    env, p, box, g, (out_ref, dQ_ref, dq_ref) = case
    out, dQ, dq, zeroed = _port_newton_vjp(env, p, box, g)
    np.testing.assert_allclose(out, out_ref, **FN_TOL, err_msg="xu_out")
    np.testing.assert_allclose(dQ, dQ_ref, **FN_TOL, err_msg="dQ")
    np.testing.assert_allclose(dq, dq_ref, **FN_TOL, err_msg="dq")
    return dq, zeroed


@pytest.mark.parametrize("name", ["pendulum", "rexquadrotor", "rexquadrotor_indefinite"])
def test_newton_function_matches_custom_vjp(newton_cases, name):
    dq, zeroed = _check_function(newton_cases[name])
    assert np.abs(dq).max() > 1e-3
    if name.endswith("indefinite"):
        # the indefinite sample's gradient was zeroed, the others' were not
        assert (dq[-1] == 0).all() and (np.abs(dq[:-1]).max(axis=(1, 2)) > 0).all()
    assert zeroed == (1 if name.endswith("indefinite") else 0)


_good_grads = newton_al.implicit_grads


def _dq_is_dx(D, O, xu_out, g_out):
    _, dx, zeroed = _good_grads(D, O, xu_out, g_out)
    return dx, dx, zeroed


def _no_zeroing(D, O, xu_out, g_out):
    dx = -newton_al.block_tridiag_solve(D.contiguous(), O.contiguous(), g_out.contiguous())
    return dx * xu_out, dx, 0


@pytest.mark.parametrize("fault", [_dq_is_dx, _no_zeroing])
def test_planted_backward_faults_fail_the_function_check(newton_cases, monkeypatch, fault):
    monkeypatch.setattr(newton_al, "implicit_grads", fault)
    with pytest.raises(AssertionError):
        _check_function(newton_cases["rexquadrotor_indefinite"])


def test_function_forward_is_the_eval_forward():
    """With a gradient or without one (inference mode), the same numbers
    come out of NewtonAL; only the first builds a graph and a backward."""
    env = make_env("rexquadrotor")
    p, box = _newton_problem(env, seed=3)

    def run(mode):
        def dyn_jac(x, u):
            xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
            return xn, torch.cat([Jx, Ju], dim=-1)

        newton = NewtonAL(NewtonALConfig(nx=env.nx, nu=env.nu, T=5), env.dynamics, dyn_jac,
                          *(torch.as_tensor(b) for b in box))
        t = {k: torch.as_tensor(v) for k, v in p.items()}
        if mode == "grad":
            t["q"].requires_grad_()
            return newton(*(t[k] for k in ARGS))[0]
        with torch.inference_mode():
            return newton(*(t[k] for k in ARGS))[0]

    with_grad, inference = run("grad"), run("inference")
    assert with_grad.grad_fn is not None and inference.grad_fn is None
    assert torch.equal(with_grad.detach(), inference)


# -- the whole training step against jax.value_and_grad ------------------------

HDIM, N, BSZ, T = 32, 2, 4, 5


@pytest.fixture(scope="module")
def pendulum_batch():
    env = make_env("pendulum")
    gt, _ = train.split_episodes(port_data.get_gt_data(env)[:40])
    batch = port_data.sample_trajectory(gt, BSZ, 1, T, np.random.default_rng(11))
    return env, train.preprocess_batch("pendulum", env.nx, batch)


def _f64_params(policy, seed):
    params = policy.init(jax.random.PRNGKey(seed))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(leaf, np.float64) + 0.05 * rng.normal(size=leaf.shape)
              for leaf in leaves]
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(v) for v in leaves])


def _policy_kw(env):
    return dict(nx=env.nx, nu=env.nu, nq=1, T=T, dt=env.dt, hdim=HDIM, deq_iter=N,
                rho_max=1e5)


@pytest.fixture(scope="module")
def step_reference(pendulum_batch):
    """JAX: loss, gradients and the clipped Adam update of one step."""
    env, batch = pendulum_batch
    jpol = JaxPolicy(JaxPolicyConfig(**_policy_kw(env), solver_dtype=jnp.float64), JaxPendulum())
    params = _f64_params(jpol, seed=5)
    opt = optax.chain(optax.clip_by_global_norm(2.0), optax.adam(1e-3))
    _, loss_fn = jax_train.make_train_step(
        jpol, opt, types.SimpleNamespace(qp_solve=True, lastqp_solve=False))
    jbatch = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in batch.items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jbatch, jnp.ones((N, 3)))
    return params, float(loss), float(aux["loss_end"]), grads


def _port_policy(env, params):
    pol = DEQMPCPolicy(PolicyConfig(**_policy_kw(env), solver_dtype=torch.float64), env,
                       device="cpu")
    pol.model.double()  # before loading: the f64 params must not pass through f32
    pol.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return pol


def test_train_step_loss_and_gradients_match_jax(pendulum_batch, step_reference):
    env, batch = pendulum_batch
    params, loss_ref, loss_end_ref, grads_ref = step_reference
    pol = _port_policy(env, params)
    d = train.loss_fn(pol, train.to_device(batch, "cpu", torch.float64))
    d["loss"].backward()
    assert pol.backward_solves == N  # one implicit backward per round
    np.testing.assert_allclose(float(d["loss"].detach()), loss_ref, **STEP_TOL)
    np.testing.assert_allclose(float(d["loss_end"].detach()), loss_end_ref, **STEP_TOL)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads_ref))
    got = dict(pol.model.named_parameters())
    assert set(ref) == set(got)
    for name, g_ref in ref.items():
        if name == "iter_emb":  # unused by the base forward: JAX zeros, no torch grad
            assert got[name].grad is None and not g_ref.numpy().any()
            continue
        np.testing.assert_allclose(got[name].grad.numpy(), g_ref.numpy(), **STEP_TOL,
                                   err_msg=name)
    # both gradient paths reach the network: through the network
    # trajectories and through the solver's implicit backward
    assert np.abs(got["out.Conv_1.kernel"].grad.numpy()).max() > 1e-4


def test_clipped_adam_update_matches_optax(pendulum_batch, step_reference):
    env, _ = pendulum_batch
    params, _, _, grads_ref = step_reference
    pol = _port_policy(env, params)
    opt = train.make_optimizer(pol, 1e-3)
    jopt = optax.chain(optax.clip_by_global_norm(2.0), optax.adam(1e-3))
    jstate = jopt.init(params)
    jparams = params
    named = dict(pol.model.named_parameters())
    for scale in (5.0, 0.5):  # the clip active, then inactive
        jgrads = jax.tree_util.tree_map(
            lambda g: g * scale / optax.global_norm(grads_ref), grads_ref)
        for name, g in params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads)).items():
            named[name].grad = None if name == "iter_emb" else g.clone()
        norm = train.clip_by_global_norm_(list(pol.model.parameters()))
        np.testing.assert_allclose(float(norm), scale, rtol=1e-12)
        opt.step()
        updates, jstate = jopt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for name, v in params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)).items():
        np.testing.assert_allclose(named[name].detach().numpy(), v.numpy(), rtol=0, atol=1e-12,
                                   err_msg=name)


def test_train_step_updates_and_counts(pendulum_batch):
    env, batch = pendulum_batch
    pol = DEQMPCPolicy(PolicyConfig(**_policy_kw(env)), env, device="cpu").init(0)
    before = {k: v.clone() for k, v in pol.model.state_dict().items()}
    opt = train.make_optimizer(pol)
    timings = {}
    out = train.train_step(pol, opt, train.to_device(batch, "cpu"), timings=timings)
    assert np.isfinite(float(out["loss"])) and float(out["grad_norm"]) > 0
    assert set(timings) == {"forward_s", "backward_s", "optimizer_s"}
    assert pol.backward_solves == N
    after = pol.model.state_dict()
    assert torch.equal(after["iter_emb"], before["iter_emb"])
    assert not torch.equal(after["out.Conv_1.kernel"], before["out.Conv_1.kernel"])


def test_seeded_init_is_reproducible_and_flax_shaped():
    env = make_env("pendulum")
    a = DEQMPCPolicy(PolicyConfig(**_policy_kw(env)), env, device="cpu").init(3)
    b = DEQMPCPolicy(PolicyConfig(**_policy_kw(env)), env, device="cpu").init(3)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = sa["cell.Conv_0.kernel"]
    k, cin, _ = w.shape
    std = (k * cin) ** -0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert not sa["cell.GroupNorm_0.bias"].any() and (sa["cell.GroupNorm_0.scale"] == 1).all()


# -- data pipeline and losses against their JAX twins ---------------------------

@pytest.fixture(scope="module")
def episodes():
    env = make_env("pendulum")
    return port_data.get_gt_data(env)[:30]


def test_expert_pickle_reader_matches_pickle(episodes, monkeypatch):
    path = port_data.expert_data_path("Pendulum-v0")
    with open(path, "rb") as f:
        ref = pickle.load(f)[:30]
    # numpy 1 names the array module numpy.core: the reader maps it there
    monkeypatch.setattr(port_datagen, "_NUMPY_2", False)
    old = port_datagen.load_expert_pickle(path)[:30]
    for got in (episodes, old):
        assert len(got) == len(ref)
        for ep, ep_ref in zip(got, ref):
            for (s, a), (s_ref, a_ref) in zip(ep, ep_ref):
                np.testing.assert_array_equal(s, s_ref)
                np.testing.assert_array_equal(a, a_ref)


def test_expert_pickle_reader_refuses_other_classes(tmp_path):
    path = tmp_path / "bad.pkl"
    path.write_bytes(pickle.dumps([types.SimpleNamespace(a=1)]))
    with pytest.raises(pickle.UnpicklingError, match="only numpy arrays"):
        port_datagen.load_expert_pickle(path)


def test_merge_and_split_match_jax(episodes):
    got, ref = port_data.merge_gt_data(episodes, 20), jax_datagen.merge_gt_data(episodes, 20)
    for k in ("state", "action", "mask"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert ref["mask"].sum() == len(ref["mask"]) - 20
    tr, val = train.split_episodes(episodes)
    n = len(episodes)
    np.testing.assert_array_equal(tr["state"], jax_datagen.merge_gt_data(
        episodes, round(n * 0.9))["state"])
    np.testing.assert_array_equal(val["state"], jax_datagen.merge_gt_data(
        episodes[round(-n * 0.1):])["state"])


@pytest.mark.parametrize("H,T_win,bsz", [(1, 5, 16), (3, 5, 16), (1, 12, 64)])
@pytest.mark.parametrize("env_name", ["pendulum", "rexquadrotor"])
def test_sample_and_preprocess_match_jax(episodes, H, T_win, bsz, env_name):
    gt = port_data.merge_gt_data(episodes)
    if env_name == "rexquadrotor":  # a 12-wide state on the same episode structure
        rng = np.random.default_rng(0)
        gt = {**gt, "state": rng.normal(size=(len(gt["state"]), 12)).astype(np.float32)}
    got = port_data.sample_trajectory(gt, bsz, H, T_win, np.random.default_rng(4))
    ref = jax_datagen.sample_trajectory(gt, bsz, H, T_win, np.random.default_rng(4))
    nx = gt["state"].shape[1]
    got = train.preprocess_batch(env_name, nx, got)
    ref = jax_train.preprocess_batch(env_name, nx, ref)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if env_name == "pendulum":
        assert ((got["obs"][..., 0] >= 0) & (got["obs"][..., 0] < 2 * np.pi)).all()


def test_angle_helpers_match_jax():
    x = np.random.default_rng(1).uniform(-7, 7, size=(3, 6, 8)).astype(np.float32)
    np.testing.assert_array_equal(train.utils.unnormalize_states_cartpole_nlink(x),
                                  jax_utils.unnormalize_states_cartpole_nlink(x))
    np.testing.assert_array_equal(train.utils.unnormalize_states_flyingcartpole(x),
                                  jax_utils.unnormalize_states_flyingcartpole(x))
    for env_name in ("pendulum", "cartpole1link", "FlyingCartpole", "rexquadrotor"):
        idx, idx_ref = (train.utils.angle_idxs_for_env(env_name, 8),
                        jax_utils.angle_idxs_for_env(env_name, 8))
        assert (idx is None) == (idx_ref is None)
        np.testing.assert_array_equal(train.utils.unwrap_angle_windows(x, idx),
                                      jax_utils.unwrap_angle_windows(x, idx_ref))


@pytest.mark.parametrize("loss_type", ["l1", "l2", "hinge"])
@pytest.mark.parametrize("out_type", [0, 1, 2, 3])
def test_losses_match_jax(loss_type, out_type):
    rng = np.random.default_rng(out_type)
    bsz, nx, nu, n_iter = 6, 4, 2, 3
    pol = types.SimpleNamespace(nq=2, T=T, out_type=out_type, loss_type=loss_type, deq_reg=0.1)
    arr = lambda *s: rng.normal(size=s)  # noqa: E731
    gt_s, gt_a = arr(bsz, T, nx), arr(bsz, T, nu)
    mask = np.cumprod(rng.uniform(size=(bsz, T)) > 0.15, axis=1).astype(np.float64)
    mask[0] = [1, 0, 0, 0, 0]  # a one-step window
    trajs = [(arr(bsz, T, nx), arr(bsz, T, nx), arr(bsz, T, nu)) for _ in range(n_iter)]
    x_init = arr(bsz, T, nx)
    coeffs = rng.uniform(size=(n_iter, 2))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    got = losses.compute_loss_deqmpc(
        pol, t(gt_s), t(gt_a), t(mask), {"trajs": [tuple(map(t, tr)) for tr in trajs]},
        coeffs=t(coeffs), x_init=t(x_init))
    ref = jax_losses.compute_loss_deqmpc(
        pol, jnp.asarray(gt_s), jnp.asarray(gt_a), jnp.asarray(mask),
        {"trajs": [tuple(map(jnp.asarray, tr)) for tr in trajs]},
        coeffs=jnp.asarray(coeffs), x_init=jnp.asarray(x_init))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-12, atol=1e-12,
                                   err_msg=k)


# -- the train CLI and its checkpoint --------------------------------------------

def test_train_cli_saves_a_checkpoint_that_eval_reads(tmp_path):
    res = train.main(["--env", "pendulum", "--model_type", "deq-mpc-deq", "--T", "5",
                      "--deq_iter", "2", "--hdim", "16", "--bsz", "4", "--max_train_steps", "2",
                      "--val_every", "1", "--save", "--name", "run", "--models_dir",
                      str(tmp_path), "--logdir", str(tmp_path / "logs"), "--device", "cpu"])
    assert [r["step"] for r in res["curve"]] == [0, 1]
    assert all(np.isfinite(r["val_loss_end"]) for r in res["curve"])
    blob = read_port_checkpoint(tmp_path / "run")  # torch.load(weights_only=True)
    assert blob["args"]["hdim"] == 16 and blob["optimizer"]["state"]
    out = port_eval.main(["--ckpt", str(tmp_path / "run"), "--episodes", "2", "--ep_len", "2",
                          "--device", "cpu"])
    assert out["n_nan_episodes"] == 0
    # and training resumes from it, optimizer state included
    res = train.main(["--env", "pendulum", "--deq_iter", "2", "--hdim", "16", "--bsz", "4",
                      "--max_train_steps", "1", "--load", "--ckpt", "run", "--models_dir",
                      str(tmp_path), "--device", "cpu"])
    assert res["curve"][0]["step"] == 0


@pytest.mark.parametrize("argv,exc,match", [
    # every flag of the JAX CLI is ported: what it refuses is what JAX refuses
    (["--model_type", "diff-mpc-deq", "--lr_schedule", "cosine"], ValueError,
     "positive decay_steps"),  # optax's cosine decay at max_train_steps <= 200
    (["--pooling", "max"], SystemExit, None),  # a flag JAX does not take
    (["--lr_schedule", "linear"], SystemExit, None),
])
def test_train_cli_refuses_what_is_not_ported(argv, exc, match):
    with pytest.raises(exc, match=match):
        train.main(["--env", "pendulum", "--device", "cpu", "--max_train_steps", "100", *argv])
