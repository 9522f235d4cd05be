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
