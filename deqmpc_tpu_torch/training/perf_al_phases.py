"""The phase split of one AL-Newton step, and the whole AL solve, on the card.

Port of `scripts/perf_al_phases.py`. At config #4's blocks (RexQuadrotor,
T 5, n = 16, f32), for each batch size it times the four phases of a
Newton step and the tracking solve they make up:

- `linearize`: the dynamics and their Jacobians at the iterate
  (`Env.dynamics_derivatives`, `vmap(jacfwd)` of the RK4 step);
- `assemble`: the merit's gradient and block Hessian (`merit_grad_blocks`);
- `tridiag`: the B1 solve (`ops.block_tridiag_solve`, the warp kernel on
  the card), beside the plain version (`ops.tridiag`);
- `linesearch20`: the merit at the 20 step sizes in one batched call, and
  the best per sample;
- `al_solve_full`: `TrackingMPC` with 2 AL iterations of at most 4 Newton
  steps, from the hover reference (the retries and exits included), and
  the Newton steps it took (`newton_steps_full`).

Each time is the median over `--n_blocks` blocks of `--n_rep` calls,
timed on the host clock up to a device sync (the eager phases are
host-bound, so the host's dispatch is part of their time). `fusible_share`
is (assemble + tridiag) over the Newton step: what a kernel fusing the
assembly and the solve could save at most.

  python -m deqmpc_tpu_torch.training.perf_al_phases [--bszs 128,512,1024] \\
      [--out al_phases.json]

One JSON line per batch size, then one with the card and all rows.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..envs import RexQuadrotor
from ..ops import block_tridiag, tridiag
from ..policies.tracking_mpc import TrackingMPC
from ..solvers.al_core import merit_function, merit_grad_blocks


def timeit(fn, *args, device, n_warm: int = 2, n_rep: int = 30, n_blocks: int = 5) -> float:
    """Seconds per call: the median over blocks of n_rep back-to-back calls
    ending in a device sync."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for _ in range(n_warm):
        fn(*args)
    sync()
    ts = []
    for _ in range(n_blocks):
        t0 = time.perf_counter()
        for _ in range(n_rep):
            fn(*args)
        sync()
        ts.append((time.perf_counter() - t0) / n_rep)
    return float(np.median(ts))


def phases(env, bsz: int, T: int, device, n_rep: int, n_blocks: int) -> Dict:
    """The times of one batch size, in ms (the JAX script's keys)."""
    nx, nu = env.nx, env.nu
    n = nx + nu
    f = dict(dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)
    xu = torch.as_tensor(rng.uniform(-0.3, 0.3, (bsz, T, n)), **f)
    x0 = xu[:, 0, :nx]
    Q = torch.as_tensor(np.concatenate([env.Qlqr, env.Rlqr]), **f).expand(bsz, T, n)
    q = -Q * xu
    lam = torch.zeros((bsz, T * nx + 2 * T * nu), **f)
    rho = torch.ones((bsz, 1), **f)
    u_lo = torch.as_tensor(env.action_space.low, **f)
    u_hi = torch.as_tensor(env.action_space.high, **f)

    def linearize(xu):
        x_next, (Jx, Ju) = env.dynamics_derivatives(xu[:, :-1, :nx], xu[:, :-1, nx:])
        return x_next, torch.cat([Jx, Ju], dim=-1)

    def assemble(xu, F, r_eq):
        return merit_grad_blocks(xu, Q, q, x0, lam, rho, F, u_lo, u_hi, dyn_eq_res=r_eq)

    def solve_kernel(g, D, O):
        return block_tridiag.block_tridiag_solve(D, O, g)

    def solve_plain(g, D, O):
        return tridiag.block_tridiag_solve(D, O, g)

    def linesearch(xu, update):
        steps = 2.0 ** (-torch.arange(20, **f))
        cands = (xu[None] + steps[:, None, None, None] * update[None]).reshape(20 * bsz, T, n)

        def rep(a):
            return a[None].expand(20, *a.shape).reshape(20 * a.shape[0], *a.shape[1:])

        merits = merit_function(env.dynamics, cands, rep(Q), rep(q), rep(x0), rep(lam),
                                rep(rho), u_lo, u_hi).reshape(20, bsz)
        return torch.argmin(merits, dim=0)

    tracking = TrackingMPC(env, T, al_iter=2, dtype=torch.float32, rho_max=1e5, device=device)
    x_ref = torch.as_tensor(env.targ_pos, **f).expand(bsz, T, nx)
    u_ref = torch.full((bsz, T, nu), env.u_hover, **f)

    def full_solve(x0_):
        return tracking(x0_, x_ref, u_ref, tracking.init_state(bsz), al_iters=2)[1]

    time_ = dict(device=device, n_rep=n_rep, n_blocks=n_blocks)
    with torch.no_grad():
        x_next, F = linearize(xu)
        x = xu[..., :nx]
        r_eq = torch.cat([x[:, 1:] - x_next, (x[:, 0] - x0)[:, None]], dim=1)
        g, D, O, _, _ = assemble(xu, F, r_eq)
        D, O, g = D.contiguous(), O.contiguous(), g.contiguous()
        upd = -solve_kernel(g, D, O)
        t_lin = timeit(linearize, xu, **time_)
        t_asm = timeit(assemble, xu, F, r_eq, **time_)
        t_sol = timeit(solve_kernel, g, D, O, **time_)
        t_plain = timeit(solve_plain, g, D, O, **time_)
        t_ls = timeit(linesearch, xu, upd, **time_)
        t_full = timeit(full_solve, x0, **{**time_, "n_rep": max(n_rep // 3, 1)})
        before = tracking.ctrl.newton.steps
        full_solve(x0)
        steps_full = tracking.ctrl.newton.steps - before
    newton = t_lin + t_asm + t_sol + t_ls
    return {"bsz": bsz, "linearize_ms": t_lin * 1e3, "assemble_ms": t_asm * 1e3,
            "tridiag_kernel_ms": t_sol * 1e3, "tridiag_plain_ms": t_plain * 1e3,
            "linesearch20_ms": t_ls * 1e3, "newton_iter_ms": newton * 1e3,
            "fusible_share": (t_asm + t_sol) / newton, "al_solve_full_ms": t_full * 1e3,
            "newton_steps_full": steps_full}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bszs", default="128,512,1024")
    ap.add_argument("--T", type=int, default=5)
    ap.add_argument("--n_rep", type=int, default=30)
    ap.add_argument("--n_blocks", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the result JSON here")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    env = RexQuadrotor()
    rows = []
    for bsz in (int(b) for b in a.bszs.split(",")):
        rows.append(phases(env, bsz, a.T, device, a.n_rep, a.n_blocks))
        print(json.dumps(rows[-1]), flush=True)
    if device.type == "cuda":
        from .eval import card_info
        card = card_info()
    else:
        card = {"kind": "cpu", "nvidia_smi": None}
    out = {"device": card, "rows": rows}
    print(json.dumps(out), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
