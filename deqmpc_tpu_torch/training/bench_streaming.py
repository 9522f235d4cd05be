"""Streaming warm-start latency per control tick (config #5).

Port of `deqmpc_tpu/training/bench_streaming.py`: the real-time budget of
receding-horizon control, one `forward_warm_start` per control tick. The
contract is the env's own control period: a tick is real time when it
takes less than dt seconds. For a single vehicle (bsz 1) and a fleet
(`--fleet_bsz`), it times the cold start (tick 0, `--deq_iter` rounds)
and the warm ticks, which run a policy of `--str_deq_iter` rounds on the
same parameters (the JAX CLI's `str_al_iter` schedule). The weights are a
seeded fresh init, as in JAX; the start states are seeded uniform draws
in [-0.3, 0.3). Each time is the host clock over `--n_rep` back-to-back
calls after `--n_warmup`, with the device synchronised before and after.
Prints one JSON line: per batch `cold_ms`, `warm_ms_per_tick` and
`realtime_margin` (dt over the warm tick's time).

  python -m deqmpc_tpu_torch.training.bench_streaming [--env rexquadrotor] \\
      [--fleet_bsz 256] [--n_rep 50] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device
from ..envs import make_env
from ..policies import DEQMPCPolicy, PolicyConfig


def time_fn(fn, sync, n_warmup: int = 3, n_rep: int = 50):
    """Seconds per call of `n_rep` calls after `n_warmup`, and the last
    result."""
    for _ in range(n_warmup):
        out = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = fn()
    sync()
    return (time.perf_counter() - t0) / n_rep, out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env", type=str, default="rexquadrotor")
    p.add_argument("--T", type=int, default=5)
    p.add_argument("--deq_iter", type=int, default=6)
    p.add_argument("--str_deq_iter", type=int, default=3,
                   help="rounds per warm tick (the str_al_iter schedule)")
    p.add_argument("--hdim", type=int, default=256)
    p.add_argument("--fleet_bsz", type=int, default=256)
    p.add_argument("--n_rep", type=int, default=50)
    p.add_argument("--n_warmup", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    env = make_env(args.env)
    nq = env.nq if env.nq <= env.nx // 2 else env.nx // 2
    results = {}
    for tag, bsz in (("single", 1), ("fleet", args.fleet_bsz)):
        kw = dict(nx=env.nx, nu=env.nu, nq=nq, T=args.T, dt=env.dt, hdim=args.hdim,
                  solver_dtype=torch.float32, rho_max=1e5)
        cold = DEQMPCPolicy(PolicyConfig(**kw, deq_iter=args.deq_iter), env, device)
        cold.init(0)
        warm = DEQMPCPolicy(PolicyConfig(**kw, deq_iter=args.str_deq_iter), env, device)
        warm.model = cold.model  # the same parameters
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.uniform(-0.3, 0.3, (bsz, env.nx)), dtype=torch.float32,
                            device=device)
        with torch.inference_mode():
            dt_cold, out = time_fn(lambda: cold.forward(x), sync, args.n_warmup,
                                   max(args.n_rep // 5, 5))
            carry = out["carry"]
            dt_warm, out_w = time_fn(lambda: warm.forward_warm_start(x, carry), sync,
                                     args.n_warmup, args.n_rep)
        u0 = torch.cat([out["trajs"][-1][2][:, 0], out_w["trajs"][-1][2][:, 0]])
        if not bool(torch.isfinite(u0).all()):
            raise RuntimeError("bench_streaming: non-finite control")
        results[tag] = {"bsz": bsz, "cold_ms": dt_cold * 1e3, "warm_ms_per_tick": dt_warm * 1e3,
                        "realtime_margin": env.dt / dt_warm}
    out = {"metric": "streaming_warm_start_latency", "env": args.env,
           "control_period_ms": env.dt * 1e3, "device": str(device),
           "deq_iter": args.deq_iter, "str_deq_iter": args.str_deq_iter,
           "n_rep": args.n_rep, **results}
    if device.type == "cuda":
        from .eval import card_info

        out.update(card_info())
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
