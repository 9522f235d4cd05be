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
