"""A/B timing of the DEQ-MPC forward and training step across variants.

Port of `scripts/perf_ab.py`. For each of `--variants` (f32: the trunk's
matmuls in f32; bf16: in bf16) a seeded policy (gcn, f32 solver, rho_max
1e5) on seeded observations and targets, and three times, each the mean
over `--n_rep` calls after 2 warm-up calls, up to a device sync:

- `net_fwd_ms`: deq_iter rounds of the network alone (no solve);
- `full_fwd_ms`: deq_iter rounds of network and AL solve;
- `train_step_ms`: the forward, the loss, its backward, clipping and Adam
  (`train.train_step`).

  python -m deqmpc_tpu_torch.training.perf_ab --env rexquadrotor --T 5 --variants f32,bf16

One JSON line per variant.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..envs import make_env
from ..policies import DEQMPCPolicy, PolicyConfig
from . import train


def _time(fn, device, n_warmup: int = 2, n_rep: int = 10):
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    out = None
    for _ in range(n_warmup):
        out = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = fn()
    sync()
    return (time.perf_counter() - t0) / n_rep, out


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env", type=str, default="rexquadrotor")
    p.add_argument("--T", type=int, default=5)
    p.add_argument("--bsz", type=int, default=128)
    p.add_argument("--hdim", type=int, default=256)
    p.add_argument("--deq_iter", type=int, default=6)
    p.add_argument("--fp_max_steps", type=int, default=10)
    p.add_argument("--variants", type=str, default="f32,bf16")
    p.add_argument("--n_rep", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    env = make_env(args.env)
    rng = np.random.default_rng(0)
    f = dict(dtype=torch.float32, device=device)
    obs = torch.as_tensor(rng.uniform(-0.3, 0.3, (args.bsz, env.nx)), **f)
    batch = {"obs": obs,
             "state": torch.as_tensor(rng.normal(size=(args.bsz, args.T, env.nx)) * 0.3, **f),
             "action": torch.full((args.bsz, args.T, env.nu), float(env.u_trim), **f),
             "mask": torch.ones((args.bsz, args.T), **f)}
    rows = []
    for variant in args.variants.split(","):
        cfg = PolicyConfig(nx=env.nx, nu=env.nu, nq=env.nx // 2, T=args.T, dt=env.dt,
                           hdim=args.hdim, layer_type="gcn", deq_iter=args.deq_iter,
                           fp_max_steps=args.fp_max_steps, solver_dtype=torch.float32,
                           rho_max=1e5,
                           compute_dtype=torch.bfloat16 if variant == "bf16" else None)
        policy = DEQMPCPolicy(cfg, env, device=device).init(0)
        optimizer = train.make_optimizer(policy)

        def net_fwd():
            with torch.inference_mode():
                return policy.forward(obs, qp_solve=False)["trajs"][-1][0]

        def fwd():
            with torch.inference_mode():
                return policy.forward(obs, qp_solve=True)["trajs"][-1][1]

        dt_net, _ = _time(net_fwd, device, n_rep=args.n_rep)
        dt_fwd, _ = _time(fwd, device, n_rep=args.n_rep)
        dt_tr, out = _time(lambda: train.train_step(policy, optimizer, batch), device,
                           n_rep=args.n_rep)
        rows.append({"variant": variant, "env": args.env, "T": args.T,
                     "net_fwd_ms": dt_net * 1e3, "full_fwd_ms": dt_fwd * 1e3,
                     "train_step_ms": dt_tr * 1e3, "fwd_throughput": args.bsz / dt_fwd,
                     "loss": float(out["loss"]), "device": str(device)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
