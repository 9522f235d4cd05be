"""The golden trajectory: an oracle from a second, independent solver.

Port of `T`, `X0`, `R_REG`, `solve_ip`, `solve_al`, `rollout_defect` and
`main` (`deqmpc_tpu/data/golden_traj.py:29-110`). The problem: the 2-link
cartpole captured to upright from a perturbed state over T = 60 knots at
dt 0.03, with the control weight regularised to R = 1e-4 (the env's 1e-10
leaves the minimiser degenerate). `solve_ip` solves it by the
interior-point SQP path (dense KKT solves); `solve_al` by the AL/Newton
path, whose Newton systems go through the block-tridiagonal solve (the
CUDA kernel on the card). The committed golden, `GOLDEN_PATH`, was made
by the IP path in f64, and the AL path must reproduce it.

  python -m deqmpc_tpu_torch.data.golden_traj [--cpu] [--out data_port/golden.npz]

writes both solves' agreement and the IP solution to `--out` (default
`data_port/golden_traj_cartpole2l.npz`; the committed file in `data/` is
read only).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import resolve_device
from ..envs import make_env
from ..solvers import QuadCost
from .datagen import DATA_DIR, PORT_DATA_DIR

GOLDEN_PATH = DATA_DIR / "golden_traj_cartpole2l.npz"
DEFAULT_OUT = PORT_DATA_DIR / "golden_traj_cartpole2l.npz"

T = 60
X0 = np.array([0.3, 0.18, -0.12, 0.2, -0.25, 0.2], np.float64)
R_REG = 1e-4


def _setup(dtype, device):
    env = make_env("cartpole2link")
    x0 = torch.as_tensor(X0, dtype=dtype, device=device)[None]
    Qv = np.concatenate([env.Qlqr, [R_REG]])
    n = env.nx + env.nu
    Qd = torch.as_tensor(Qv, dtype=dtype, device=device).expand(1, T, n)
    cost = QuadCost(Q=Qd, q=torch.zeros((1, T, n), dtype=dtype, device=device),
                    f=torch.zeros((1, T), dtype=dtype, device=device))
    return env, x0, cost


def solve_ip(dtype=torch.float64, qp_iter: int = 12, device="cuda"):
    """The interior-point SQP solve: (X (T, 6), U (T, 1)) in f64 numpy."""
    from ..policies.tracking_mpc import TrackingMPC

    device = resolve_device(device)
    env, x0, cost = _setup(dtype, device)
    tr = TrackingMPC(env, T, dtype=dtype, solver_type="ip", qp_iter=qp_iter, device=device)
    with torch.inference_mode():
        x, u = tr.ip_ctrl.solve(x0, cost)
    return x[0].double().cpu().numpy(), u[0].double().cpu().numpy()


def solve_al(dtype=torch.float64, al_iters: int = 10, device="cuda"):
    """The AL/Newton solve, cold, at max_newton_steps 8 and rho_max 1e8."""
    from ..policies.tracking_mpc import TrackingMPC

    device = resolve_device(device)
    env, x0, cost = _setup(dtype, device)
    tr = TrackingMPC(env, T, dtype=dtype, al_iter=al_iters, max_newton_steps=8, rho_max=1e8,
                     device=device)
    with torch.inference_mode():
        x, u, _, _ = tr.ctrl.solve(x0, cost, tr.init_state(1), al_iter=al_iters)
    return x[0].double().cpu().numpy(), u[0].double().cpu().numpy()


def rollout_defect(X, U) -> float:
    """The plan's largest dynamics defect |x_{t+1} - f(x_t, u_t)|, in f64 on the CPU."""
    env = make_env("cartpole2link")
    X = torch.as_tensor(np.asarray(X), dtype=torch.float64)
    U = torch.as_tensor(np.asarray(U), dtype=torch.float64)
    xn = env.dynamics(X[:-1], U[:-1])
    return float((xn - X[1:]).abs().max())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--out", type=str, default=str(DEFAULT_OUT))
    a = p.parse_args(argv)
    device = "cpu" if a.cpu else "cuda"
    X_ip, U_ip = solve_ip(device=device)
    X_al, U_al = solve_al(device=device)
    d_ip, d_al = rollout_defect(X_ip, U_ip), rollout_defect(X_al, U_al)
    du, dx = np.abs(U_ip - U_al).max(), np.abs(X_ip - X_al).max()
    print(f"IP defect {d_ip:.2e}  AL defect {d_al:.2e}  max|dU| {du:.2e}  max|dX| {dx:.2e}")
    if not (du < 1e-3 and dx < 1e-4):
        raise SystemExit("solvers disagree; not a valid golden")
    if os.path.realpath(os.path.dirname(a.out)) == os.path.realpath(DATA_DIR):
        raise SystemExit(f"{a.out}: the port never writes into the committed data/")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    np.savez(a.out, X=X_ip, U=U_ip, x0=X0, T=T, R=R_REG, dt=0.03, producer="ip_sqp_f64")
    print(f"wrote {a.out}")
    return {"defect_ip": d_ip, "defect_al": d_al, "max_dU": du, "max_dX": dx}


if __name__ == "__main__":
    main()
