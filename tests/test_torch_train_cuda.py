"""The training path on the card: the NewtonAL Function's implicit backward
through the CUDA kernel against the same Function on the CPU's plain
solve, and one training step whose backward launches the warp kernel once
per round. The kernels have no CPU mode, so these tests skip without a
GPU.

The module imports only torch, numpy and the port, so it also runs on a
GPU machine without JAX; there, skip `tests/conftest.py` (which sets up
JAX):

  python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
      tests/test_torch_train_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.ops import block_tridiag as bt  # noqa: E402
from deqmpc_tpu_torch.policies import DEQMPCPolicy, PolicyConfig  # noqa: E402
from deqmpc_tpu_torch.solvers import NewtonAL, NewtonALConfig  # noqa: E402
from deqmpc_tpu_torch.training import train  # noqa: E402

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs an NVIDIA GPU: the CUDA kernel has no CPU mode"),
]


def _problem(env, bsz=16, T=5, seed=0):
    """A well-conditioned NewtonAL problem in f64 (rho 10, positive cost)."""
    nx, nu = env.nx, env.nu
    lo, hi = env.action_space.low.astype(np.float64), env.action_space.high.astype(np.float64)
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.normal(size=(bsz, T, nx))
    u = (lo + hi) / 2 + 0.5 * (hi - lo) / 2 * rng.uniform(-1, 1, size=(bsz, T, nu))
    xu = np.concatenate([x, u], axis=-1)
    Q = np.broadcast_to(np.concatenate([env.Qlqr, np.full(nu, 0.1)]), xu.shape).copy()
    q = -Q * (xu + 0.2 * rng.normal(size=xu.shape))
    x0 = x[:, 0] + 0.1 * rng.normal(size=(bsz, nx))
    lam = np.zeros((bsz, T * nx + 2 * nu * T))
    rho = np.full((bsz, 1), 10.0)
    g = rng.normal(size=xu.shape)
    return dict(xu=xu, x0=x0, lam=lam, rho=rho, Q=Q, q=q), (lo, hi), g


def _function_vjp(env, p, box, g, device):
    def dyn_jac(x, u):
        xn, (Jx, Ju) = env.dynamics_derivatives(x, u)
        return xn, torch.cat([Jx, Ju], dim=-1)

    newton = NewtonAL(NewtonALConfig(nx=env.nx, nu=env.nu, T=p["xu"].shape[1]), env.dynamics,
                      dyn_jac, *(torch.as_tensor(b, device=device) for b in box))
    t = {k: torch.as_tensor(v, device=device) for k, v in p.items()}
    Q, q = t["Q"].requires_grad_(), t["q"].requires_grad_()
    out, _ = newton(t["xu"], t["x0"], t["lam"], t["rho"], Q, q)
    out.backward(torch.as_tensor(g, device=device))
    assert newton.backward_solves == 1
    return out.detach().cpu(), Q.grad.cpu(), q.grad.cpu()


@pytest.mark.parametrize("env_name", ["pendulum", "rexquadrotor"])
def test_function_backward_on_card_matches_cpu(env_name):
    env = make_env(env_name)
    p, box, g = _problem(env)
    before = dict(bt.block_tridiag_solve.launches_by_kernel)
    card = _function_vjp(env, p, box, g, "cuda")
    after = bt.block_tridiag_solve.launches_by_kernel
    assert after["warp"] > before["warp"] and after["block"] == before["block"]
    cpu = _function_vjp(env, p, box, g, "cpu")
    for name, a, b in zip(("xu_out", "dQ", "dq"), card, cpu):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-9, msg=name)
    assert float(card[2].abs().max()) > 1e-3


def test_training_step_backward_launches_the_warp_kernel_once_per_round():
    env = make_env("pendulum")
    cfg = PolicyConfig(nx=env.nx, nu=env.nu, nq=1, T=5, dt=env.dt, hdim=32, deq_iter=6,
                       rho_max=1e5)
    pol = DEQMPCPolicy(cfg, env, device="cuda").init(0)
    rng = np.random.default_rng(0)
    obs = np.stack([rng.uniform(0, 2 * np.pi, 8), rng.uniform(-1, 1, 8)], axis=-1)
    batch = {"obs": obs[:, None], "state": obs[:, None] + 0.1 * rng.normal(size=(8, 5, 2)),
             "action": rng.normal(size=(8, 5, 1)), "mask": np.ones((8, 5))}
    batch = train.to_device(batch, "cuda")
    d = train.loss_fn(pol, batch)
    launches = dict(bt.block_tridiag_solve.launches_by_kernel)
    d["loss"].backward()
    torch.cuda.synchronize()
    by_kernel = bt.block_tridiag_solve.launches_by_kernel
    assert by_kernel["warp"] - launches["warp"] == 6 and by_kernel["block"] == launches["block"]
    assert pol.backward_solves == 6
    grads = [p.grad for p in pol.model.parameters() if p.grad is not None]
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)


def _streaming_pair(seed=0):
    """The same f64 pendulum policy (hdim 32, N 2) on the card and on the CPU."""
    env = make_env("pendulum")
    cfg = PolicyConfig(nx=env.nx, nu=env.nu, nq=1, T=5, dt=env.dt, hdim=32, deq_iter=2,
                       rho_max=1e5, solver_dtype=torch.float64)
    pols = {}
    for dev in ("cuda", "cpu"):
        pols[dev] = DEQMPCPolicy(cfg, env, device=dev).init(seed)
        pols[dev].model.double()
    return env, pols


def test_warm_tick_on_card_matches_cpu():
    env, pols = _streaming_pair()
    obs = env.reset(torch.Generator().manual_seed(3), 8, device="cpu", dtype=torch.float64)
    obs1 = obs + 0.05
    u = {}
    for dev, pol in pols.items():
        with torch.inference_mode():
            out = pol.forward(obs.to(dev))
            out = pol.forward_warm_start(obs1.to(dev), out["carry"])
        u[dev] = out["trajs"][-1][2].cpu()
    torch.testing.assert_close(u["cuda"], u["cpu"], rtol=1e-6, atol=1e-6)
    assert pols["cuda"].newton_steps > 0


def test_streaming_step_on_card_matches_cpu():
    env, pols = _streaming_pair(seed=1)
    rng = np.random.default_rng(1)
    L = 2
    state = np.stack([rng.uniform(0, 2 * np.pi, (8, 5 + L)), rng.uniform(-1, 1, (8, 5 + L))], -1)
    batch = {"obs": state[:, :1], "state": state + 0.01 * rng.normal(size=state.shape),
             "action": rng.normal(size=(8, 5 + L, 1)), "mask": np.ones((8, 5 + L))}
    grads, losses = {}, {}
    for dev, pol in pols.items():
        launches = dict(bt.block_tridiag_solve.launches_by_kernel)
        d = train.make_loss_fn(L)(pol, train.to_device(batch, dev, torch.float64))
        before = pol.backward_solves
        d["loss"].backward()
        assert pol.backward_solves - before == 2 * (1 + L)  # one per round of each forward
        if dev == "cuda":
            torch.cuda.synchronize()
            by_kernel = bt.block_tridiag_solve.launches_by_kernel
            assert by_kernel["warp"] > launches["warp"] and by_kernel["block"] == launches["block"]
        losses[dev] = float(d["loss"])
        grads[dev] = {k: p.grad.cpu() for k, p in pol.model.named_parameters() if p.grad is not None}
    assert np.isclose(losses["cuda"], losses["cpu"], rtol=1e-6, atol=0)
    assert set(grads["cuda"]) == set(grads["cpu"])
    for k, g in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][k], g, rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()), msg=k)


# -- configs #2 and #3b: the cartpole (T 10) and the flying cartpole with obstacle rows --

NEW_CASES = {"cartpole": ("cartpole1link", 10, 2, "deq"),
             "flying_obstacles": ("flyingcartpole_obstacles", 5, 7, "nn")}


def _new_pair(case, seed=0):
    """The same f64 policy (hdim 32, N 2) on the card and on the CPU; the
    flying cartpole's carries the rows of its obstacle field."""
    env_name, T, nq, deq_type = NEW_CASES[case]
    env = make_env(env_name)
    cfg = PolicyConfig(nx=env.nx, nu=env.nu, nq=nq, T=T, dt=env.dt, hdim=32, deq_iter=2,
                       rho_max=1e5, deq_type=deq_type, solver_dtype=torch.float64)
    pols = {}
    for dev in ("cuda", "cpu"):
        pols[dev] = DEQMPCPolicy(cfg, env, device=dev,
                                 obstacles=train.build_obstacles(env)).init(seed)
        pols[dev].model.double()
    obs = env.reset(torch.Generator().manual_seed(3), 8, device="cpu", dtype=torch.float64)
    if case == "flying_obstacles":  # start beside spheres: their rows are active
        obs[:, :3] = torch.as_tensor(env.obstacle_positions[:8]) + 0.1
    return env, pols, obs


@pytest.mark.parametrize("case", sorted(NEW_CASES))
def test_new_config_tick_on_card_matches_cpu(case):
    env, pols, obs = _new_pair(case)
    u = {}
    for dev, pol in pols.items():
        launches = dict(bt.block_tridiag_solve.launches_by_kernel)
        with torch.inference_mode():
            out = pol.forward(obs.to(dev))
        u[dev] = out["trajs"][-1][2].cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            by_kernel = bt.block_tridiag_solve.launches_by_kernel
            assert by_kernel["warp"] > launches["warp"] and by_kernel["block"] == launches["block"]
    torch.testing.assert_close(u["cuda"], u["cpu"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", sorted(NEW_CASES))
def test_new_config_train_step_on_card_matches_cpu(case):
    env, pols, obs = _new_pair(case, seed=1)
    rng = np.random.default_rng(1)
    T = pols["cpu"].T
    state = obs.numpy()[:, None] + 0.05 * rng.normal(size=(8, T, env.nx))
    batch = {"obs": obs.numpy()[:, None], "state": state,
             "action": 0.1 * rng.normal(size=(8, T, env.nu)), "mask": np.ones((8, T))}
    grads, losses = {}, {}
    for dev, pol in pols.items():
        d = train.loss_fn(pol, train.to_device(batch, dev, torch.float64))
        d["loss"].backward()
        assert pol.backward_solves == 2  # one per round
        losses[dev] = float(d["loss"])
        grads[dev] = {k: p.grad.cpu() for k, p in pol.model.named_parameters() if p.grad is not None}
    assert np.isclose(losses["cuda"], losses["cpu"], rtol=1e-6, atol=0)
    assert set(grads["cuda"]) == set(grads["cpu"])
    for k, g in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][k], g, rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()), msg=k)


# -- diff-mpc-deq (one round, then the final 10-iteration solve) and the
# interior-point layer ---------------------------------------------------------

# JAX's own relative gradient move at the diff-mpc step below, rho_max 1e5,
# under 1e-14 relative moves of the start states: at least this much
# (`tests/test_torch_diffmpc.py::test_diffmpc_step_gradient_at_rho_max_jumps_in_jax_too`
# measures it: 0.447 at the largest of 8 moves)
JAX_GRADIENT_JUMP = 0.4
SENSITIVITY_FACTOR = 10.0


def _diffmpc_pair(seed=0, rho_max=1e5, devices=("cuda", "cpu")):
    """The same f64 diff-mpc-deq pendulum policy (hdim 32) on the card and
    on the CPU."""
    env = make_env("pendulum")
    cfg = PolicyConfig(nx=env.nx, nu=env.nu, nq=1, T=5, dt=env.dt, hdim=32, deq_iter=1,
                       rho_max=rho_max, solver_dtype=torch.float64, qp_solve=False,
                       lastqp_solve=True)
    pols = {}
    for dev in devices:
        pols[dev] = DEQMPCPolicy(cfg, env, device=dev).init(seed)
        pols[dev].model.double()
    return env, pols


def _diffmpc_step_batch():
    """The seeded pendulum batch of the diff-mpc training steps (8 samples)."""
    rng = np.random.default_rng(1)
    obs = np.stack([rng.uniform(0, 2 * np.pi, 8), rng.uniform(-1, 1, 8)], axis=-1)
    return {"obs": obs[:, None], "state": obs[:, None] + 0.1 * rng.normal(size=(8, 5, 2)),
            "action": rng.normal(size=(8, 5, 1)), "mask": np.ones((8, 5))}


def test_diffmpc_tick_on_card_matches_cpu():
    """The card's first actions within 1e-6 of the CPU's on all samples but
    one, and that one within the f64 tick-0 limit of 1e-3: the final solve
    ends at rho 1e5, where a line-search tie can move a sample by far more
    than its rounding (JAX's own controls move by 2.5e-3 under a 1e-14
    move of the start states on a sample of `tests/test_torch_diffmpc.py`)."""
    env, pols = _diffmpc_pair()
    obs = env.reset(torch.Generator().manual_seed(3), 8, device="cpu", dtype=torch.float64)
    u = {}
    with torch.inference_mode():
        for dev, pol in pols.items():
            launches = dict(bt.block_tridiag_solve.launches_by_kernel)
            u[dev] = pol.forward(obs.to(dev))["trajs"][-1][2].cpu()
            if dev == "cuda":
                torch.cuda.synchronize()
                by = bt.block_tridiag_solve.launches_by_kernel
                assert by["warp"] - launches["warp"] == pol.newton_steps + pol.newton_retries
    gap = (u["cuda"] - u["cpu"]).abs().flatten(1).amax(dim=1)
    assert int((gap > 1e-6).sum()) <= 1 and float(gap.max()) <= 1e-3, gap
    assert pols["cuda"].newton_steps > 10  # the final solve ran on the card


def test_diffmpc_train_step_on_card_matches_cpu():
    """At rho_max 1e3. At the config's 1e5 the final solve leaves controls
    on the box bound within rounding, and whether a bound's row enters the
    backward's Hessian (a jump of rho in one entry of D) is rounding, and
    the gradients then part while the losses agree (the test below). JAX's
    own gradient jumps so too (JAX_GRADIENT_JUMP). No sample may be zeroed
    on either device."""
    env, pols = _diffmpc_pair(seed=1, rho_max=1e3)
    batch = _diffmpc_step_batch()
    grads, losses = {}, {}
    for dev, pol in pols.items():
        launches = dict(bt.block_tridiag_solve.launches_by_kernel)
        d = train.loss_fn(pol, train.to_device(batch, dev, torch.float64))
        d["loss"].backward()
        assert pol.backward_solves == 1  # the final solve's backward alone
        assert int(pol.newton_solver.backward_zeroed) == 0
        if dev == "cuda":
            torch.cuda.synchronize()
            by = bt.block_tridiag_solve.launches_by_kernel
            assert by["warp"] > launches["warp"] and by["block"] == launches["block"]
        losses[dev] = float(d["loss"])
        grads[dev] = {k: p.grad.cpu() for k, p in pol.model.named_parameters() if p.grad is not None}
    assert np.isclose(losses["cuda"], losses["cpu"], rtol=1e-6, atol=0)
    assert set(grads["cuda"]) == set(grads["cpu"])
    for k, g in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][k], g, rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()), msg=k)


def test_qp_layer_gradient_on_card_matches_cpu():
    """The interior-point layer's forward and its implicit backward (the six
    input gradients) on the card against the CPU, f64, on a feasible batch
    with active inequalities."""
    from deqmpc_tpu_torch.solvers import pdipm

    rng = np.random.default_rng(0)
    bsz, nz, ni, ne = 16, 6, 5, 2
    L = rng.normal(size=(bsz, nz, nz))
    Q = L @ np.swapaxes(L, -1, -2) + nz * np.eye(nz)
    p, G, A = rng.normal(size=(bsz, nz)), rng.normal(size=(bsz, ni, nz)), rng.normal(
        size=(bsz, ne, nz))
    z_f = rng.normal(size=(bsz, nz))
    h = np.einsum("bij,bj->bi", G, z_f) + 0.1 * np.abs(rng.normal(size=(bsz, ni)))
    b = np.einsum("bij,bj->bi", A, z_f)
    gz = rng.normal(size=(bsz, nz))
    res = {}
    for dev in ("cuda", "cpu"):
        t = [torch.as_tensor(a, device=dev).requires_grad_() for a in (Q, p, G, h, A, b)]
        z = pdipm.qp_layer(*t, 25)
        z.backward(torch.as_tensor(gz, device=dev))
        res[dev] = [z.detach().cpu()] + [a.grad.cpu() for a in t]
    for name, a, c in zip(("z", "dQ", "dp", "dG", "dh", "dA", "db"), res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, c, rtol=1e-8, atol=1e-9, msg=name)
    assert float(res["cpu"][4].abs().max()) > 1e-3  # active rows: h has a gradient


def test_diffmpc_backward_at_rho_max_turns_on_the_active_set(monkeypatch):
    """The config's rho_max 1e5, the step of the test above: the losses
    agree, and where the backward's Hessian blocks D differ between the
    card and the CPU they differ by exactly rho, a box row active on one
    device only (a control the final solve leaves on its bound within
    rounding). The solves themselves agree on the same D, and the CPU's
    step given the card's D (its active set) gives the card's gradient
    within 1e-5, the step tests' limit (1.3e-6 on an H100: the rho rows
    raise the system's condition): the active set is the gap, which stays
    within SENSITIVITY_FACTOR x JAX's own gradient jump under a 1e-14 move
    of the start states. Prints the numbers PERF.md reports."""
    from deqmpc_tpu_torch.ops import tridiag
    from deqmpc_tpu_torch.solvers import newton_al

    env, pols = _diffmpc_pair(seed=1)
    batch = _diffmpc_step_batch()
    good, kept, losses, grads = newton_al.implicit_grads, {}, {}, {}
    for dev, pol in pols.items():
        def keep(D, O, xu, g, dev=dev):
            kept[dev] = [t.detach().cpu().clone() for t in (D, O, g)]
            return good(D, O, xu, g)

        monkeypatch.setattr(newton_al, "implicit_grads", keep)
        d = train.loss_fn(pol, train.to_device(batch, dev, torch.float64))
        d["loss"].backward()
        losses[dev] = float(d["loss"])
        grads[dev] = torch.cat([p.grad.flatten().cpu() for p in pol.model.parameters()
                                if p.grad is not None])
    # the CPU's step again, its backward given the card's Hessian blocks
    monkeypatch.setattr(newton_al, "implicit_grads",
                        lambda D, O, xu, g: good(kept["cuda"][0].to(D), O, xu, g))
    pols["cpu"].model.zero_grad(set_to_none=True)
    train.loss_fn(pols["cpu"], train.to_device(batch, "cpu", torch.float64))["loss"].backward()
    replayed = torch.cat([p.grad.flatten() for p in pols["cpu"].model.parameters()
                          if p.grad is not None])
    rho = pols["cpu"].cfg.rho_max
    (D_card, _, _), (D, O, g) = kept["cuda"], kept["cpu"]
    diff = (D_card - D).abs()
    moved = diff > 1e-6 * float(D.abs().max())
    x_plain = tridiag.block_tridiag_solve(D, O, g)
    x_kernel = bt.block_tridiag_solve(D.cuda(), O.cuda(), g.cuda()).cpu()
    H = tridiag.block_tridiag_dense(D.tril() + D.tril(-1).mT, O)
    x_dense = torch.linalg.solve(H, g.reshape(g.shape[0], -1, 1)).reshape(g.shape)
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    grad_gap = rel(grads["cuda"], grads["cpu"])
    print(f"loss gap {abs(losses['cuda'] - losses['cpu']) / abs(losses['cpu']):.3g}, "
          f"D entries moved {int(moved.sum())} (by {diff[moved].tolist()}), gradient gap "
          f"{grad_gap:.3g}, the CPU's given the card's D {rel(grads['cuda'], replayed):.3g}; "
          f"same D: kernel vs plain {rel(x_kernel, x_plain):.3g}, "
          f"dense LU vs plain {rel(x_dense, x_plain):.3g}")
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-9 * abs(losses["cpu"])
    assert bool(((diff[moved] - rho).abs() <= 1e-6 * rho).all())
    assert rel(x_kernel, x_plain) <= 1e-8 and rel(x_dense, x_plain) <= 1e-8
    assert rel(grads["cuda"], replayed) <= 1e-5
    assert grad_gap <= SENSITIVITY_FACTOR * JAX_GRADIENT_JUMP
    if not bool(moved.any()):
        assert grad_gap <= 1e-5


# -- the policy variants: a delta step (its scales' EMA included) and an
# estpred step (the MHE estimator's solves on the card) -------------------------

def _variant_step(variant, H, seed=2, **opts):
    """One f64 training step of a fresh pendulum variant policy (hdim 32,
    N 2, rho_max 1e3, with the args `opts`) on the card and on the CPU from
    the same weights: the loss and the gradients, then the step (Adam, and
    for delta the EMA of its scales)."""
    from deqmpc_tpu_torch.policies import build_policy

    env = make_env("pendulum")
    args = {"T": 5, "nq": 1, "hdim": 32, "deq_iter": 2, "policy_variant": variant, "H": H,
            "dtype": "double", "rho_max": 1e3, **opts}
    state = build_policy(args, env, "cpu").init(seed).model.state_dict()
    rng = np.random.default_rng(seed)
    obs = np.stack([rng.uniform(0, 2 * np.pi, (8, H)), rng.uniform(-1, 1, (8, H))], axis=-1)
    batch = {"obs": obs, "obs_action": rng.normal(size=(8, H, 1)),
             "state": obs[:, -1:] + 0.1 * rng.normal(size=(8, 5, 2)),
             "action": rng.normal(size=(8, 5, 1)), "mask": np.ones((8, 5))}
    out = {}
    for dev in ("cuda", "cpu"):
        pol = build_policy(args, env, dev)
        pol.model.double()
        pol.model.load_state_dict({k: v.to(dev) for k, v in state.items()})
        tb = train.to_device(batch, dev, torch.float64)
        launches = dict(bt.block_tridiag_solve.launches_by_kernel)
        d = train.loss_fn(pol, tb)
        d["loss"].backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            by = bt.block_tridiag_solve.launches_by_kernel
            assert by["warp"] - launches["warp"] == (pol.newton_steps + pol.newton_retries
                                                     + pol.backward_solves)
            assert by["block"] == launches["block"]
        grads = {k: p.grad.cpu() for k, p in pol.model.named_parameters() if p.grad is not None}
        train.train_step(pol, train.make_optimizer(pol), tb)  # the step, from the same weights
        out[dev] = (float(d["loss"]), grads, pol)
    return out


@pytest.mark.parametrize("variant,H", [("delta", 1), ("estpred", 3)])
def test_variant_train_step_on_card_matches_cpu(variant, H):
    (l_card, g_card, pol), (l_cpu, g_cpu, pol_cpu) = _variant_step(variant, H).values()
    assert np.isclose(l_card, l_cpu, rtol=1e-6, atol=0)
    assert set(g_card) == set(g_cpu)
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_card[k], g, rtol=1e-5, atol=1e-5 * float(g.abs().max()),
                                   msg=k)
    if variant == "delta":  # the scales after Adam and the EMA
        torch.testing.assert_close(pol.model.scales.detach().cpu(), pol_cpu.model.scales.detach(),
                                   rtol=1e-6, atol=1e-9)
    else:
        # the estimator's Newton steps retried (its last block is singular on
        # the controls), on the card as on the CPU
        assert pol.newton_retries > 0 and pol_cpu.newton_retries > 0


# -- the true DEQ gradient and the cost refresh (slice 8) ----------------------------------

@pytest.mark.parametrize("opts", [{"grad_type": "implicit", "max_steps": 4},
                                  {"fp_type": "broyden", "grad_type": "implicit"},
                                  {"recompute_Qq": True}], ids=["implicit", "broyden_implicit",
                                                                "recompute_Qq"])
def test_slice8_train_step_on_card_matches_cpu(opts):
    """A base-policy step with the implicit backward (its transpose solve on
    the card) or with the cost refresh (no solve takes a gradient), card vs
    CPU, as the variants' steps. Anderson's transpose solve runs 4 steps
    here: at this fresh init a 1e-14 to 1e-10 move of the backward's
    cotangent moves the whole CPU gradient by 4-18% at the default 10 steps
    and by 5e-11 at 4 (measured), in JAX's algorithm as here (ROADMAP, known
    behaviours); the one-step adjoint w = g moves it by 79% at 4 steps."""
    (l_card, g_card, pol), (l_cpu, g_cpu, pol_cpu) = _variant_step("base", 1, **opts).values()
    assert np.isclose(l_card, l_cpu, rtol=1e-6, atol=0)
    assert set(g_card) == set(g_cpu)
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_card[k], g, rtol=1e-5, atol=1e-5 * float(g.abs().max()),
                                   msg=lambda m, k=k: f"{k}: {m}")
    # one implicit backward a round, for the loss's backward and the step's
    assert pol.backward_solves == pol_cpu.backward_solves == (0 if "recompute_Qq" in opts
                                                              else 4)
