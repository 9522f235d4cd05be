"""Where one training step spends its time: network, solver, loss, backward.

Port of `deqmpc_tpu/training/profile_step.py`. A seeded policy (gcn, f32
solver, rho_max 1e5) on random observations and targets; four phases,
each timed over `--n_rep` calls after 2 warm-up calls, each ending with a
device sync (`utils.profiling.PhaseTimer`):

- `network_fwd`: deq_iter rounds of the network alone (qp_solve off)
- `full_fwd`:    deq_iter rounds of network -> AL solve
- `fwd_loss`:    the same and the per-round loss
- `train_step`:  the same, backward, clip and Adam (the real step)

The forward phases run without autograd. solver_fwd = full_fwd -
network_fwd; backward_opt = train_step - fwd_loss. The JSON keys are
JAX's. `--trace` runs 3 more steps under `utils.profiling.device_trace`
(a Chrome trace in `--trace_dir`).

  python -m deqmpc_tpu_torch.training.profile_step [--env cartpole1link --T 10 \\
      --hdim 256 --bsz 128] [--n_rep 10] [--trace] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import resolve_device
from ..envs import make_env
from ..policies import DEQMPCPolicy, PolicyConfig, compute_loss_deqmpc
from ..utils.profiling import PhaseTimer, device_trace
from .train import clip_by_global_norm_, make_optimizer


def _time(timer: PhaseTimer, name: str, fn, sync, n_warmup: int = 2, n_rep: int = 10) -> float:
    for _ in range(n_warmup):
        fn()
    if sync.is_cuda:
        torch.cuda.synchronize()
    with timer.phase(name, sync=sync):
        for _ in range(n_rep):
            fn()
    return timer.summary()[name] / n_rep


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env", type=str, default="cartpole1link")
    p.add_argument("--T", type=int, default=10)
    p.add_argument("--deq_iter", type=int, default=6)
    p.add_argument("--hdim", type=int, default=256)
    p.add_argument("--bsz", type=int, default=128)
    p.add_argument("--n_rep", type=int, default=10)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--trace_dir", type=str, default="logs/deqmpc_trace")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    env = make_env(args.env)
    nq = env.nq if env.nq <= env.nx // 2 else env.nx // 2
    cfg = PolicyConfig(nx=env.nx, nu=env.nu, nq=nq, T=args.T, dt=env.dt, hdim=args.hdim,
                       layer_type="gcn", deq_iter=args.deq_iter, solver_dtype=torch.float32,
                       rho_max=1e5)
    policy = DEQMPCPolicy(cfg, env, device=device).init(0)
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    obs = torch.as_tensor(rng.uniform(-0.3, 0.3, (args.bsz, env.nx)), **f32)
    batch = {"state": torch.as_tensor(rng.normal(size=(args.bsz, args.T, env.nx)) * 0.3, **f32),
             "action": torch.as_tensor(rng.normal(size=(args.bsz, args.T, env.nu)), **f32),
             "mask": torch.ones((args.bsz, args.T), **f32)}
    optimizer = make_optimizer(policy, 1e-3)

    def loss_fn():
        po = policy.forward(obs, qp_solve=True)
        return compute_loss_deqmpc(policy, batch["state"], batch["action"], batch["mask"], po,
                                   x_init=po["init_states"])["loss"]

    @torch.no_grad()
    def network_fwd():
        return policy.forward(obs, qp_solve=False)["trajs"][-1][0]

    @torch.no_grad()
    def full_fwd():
        return policy.forward(obs, qp_solve=True)["trajs"][-1][1]

    fwd_loss = torch.no_grad()(loss_fn)

    def train_step():
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        clip_by_global_norm_(list(policy.model.parameters()))
        optimizer.step()
        return loss

    timer = PhaseTimer()
    t_net = _time(timer, "network_fwd", network_fwd, obs, n_rep=args.n_rep)
    t_full = _time(timer, "full_fwd", full_fwd, obs, n_rep=args.n_rep)
    t_loss = _time(timer, "fwd_loss", fwd_loss, obs, n_rep=args.n_rep)
    t_step = _time(timer, "train_step", train_step, obs, n_rep=args.n_rep)

    out = {
        "env": args.env, "T": args.T, "bsz": args.bsz, "hdim": args.hdim,
        "network_fwd_ms": round(t_net * 1e3, 2),
        "solver_fwd_ms": round((t_full - t_net) * 1e3, 2),
        "full_fwd_ms": round(t_full * 1e3, 2),
        "loss_overhead_ms": round((t_loss - t_full) * 1e3, 2),
        "backward_opt_ms": round((t_step - t_loss) * 1e3, 2),
        "train_step_ms": round(t_step * 1e3, 2),
    }
    print(json.dumps(out), flush=True)

    if args.trace:
        with device_trace(args.trace_dir) as logdir:
            for _ in range(3):
                train_step()
        print(f"trace written to {logdir}", flush=True)
    return out


if __name__ == "__main__":
    main()
