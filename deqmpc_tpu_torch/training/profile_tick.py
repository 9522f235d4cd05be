"""Where one closed-loop tick spends its time, from `torch.profiler`.

Serves `--episodes` episodes from a checkpoint: one warm-up tick, then
`--ticks` ticks under the profiler. Reports the wall time per tick, the
device's busy time per tick (the sum of its kernels' times), the
kernels launched per tick, the block-tridiagonal kernel's share, and
the operators that take the most host and device time.

  python -m deqmpc_tpu_torch.training.profile_tick --ckpt checkpoints/rexquad_deqmpc \
      [--episodes 32] [--ticks 2] [--out profile.json]
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import resolve_device
from ..envs import make_env_of
from ..ops import block_tridiag as bt
from ..policies import build_policy
from ..utils.checkpoint import load_checkpoint
from .eval import card_info


def _tick(policy, env, x):
    u0 = policy.forward(x)["trajs"][-1][2][:, 0]
    x, _ = env.step(x, u0)
    return x


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--episodes", type=int, default=32)
    ap.add_argument("--ticks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the report JSON here")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    state, args = load_checkpoint(a.ckpt, device)
    env = make_env_of(args)
    policy = build_policy(args, env, device)
    policy.model.load_state_dict(state)
    x = env.reset(torch.Generator().manual_seed(0), a.episodes, device=device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with torch.inference_mode():
        x = _tick(policy, env, x)  # warm-up: allocator, cuBLAS handles
        sync()
        launches0, steps0 = bt.block_tridiag_solve.launches, policy.newton_steps
        by_kernel0 = dict(bt.block_tridiag_solve.launches_by_kernel)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(a.ticks):
                x = _tick(policy, env, x)
            sync()
            wall = (time.perf_counter() - t0) / a.ticks
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda]

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)

    device_us = sum(dev_us(e) for e in kernels) / a.ticks
    solve_us = sum(dev_us(e) for e in kernels
                   if any(f in e.key for f in bt.KERNEL_FUNCTIONS.values())) / a.ticks
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    top_host = [e for e in top_host if e.device_type != cuda]
    top_dev = sorted(kernels, key=dev_us, reverse=True)[:15]
    report = {
        "ckpt": a.ckpt, "episodes": a.episodes, "ticks": a.ticks, "device": str(device),
        "tick_wall_ms": wall * 1e3,
        "device_busy_ms_per_tick": device_us / 1e3,
        "device_idle_share": 1.0 - device_us / 1e3 / (wall * 1e3) if on_card else None,
        "kernel_launches_per_tick": sum(e.count for e in kernels) / a.ticks,
        "block_tridiag_ms_per_tick": solve_us / 1e3,
        "block_tridiag_launches_per_tick": (bt.block_tridiag_solve.launches - launches0) / a.ticks,
        "block_tridiag_launches_by_kernel": {
            k: (bt.block_tridiag_solve.launches_by_kernel[k] - by_kernel0[k]) / a.ticks
            for k in bt.KERNELS},
        "newton_steps_per_tick": (policy.newton_steps - steps0) / a.ticks,
        "top_host_ops": [{"op": e.key, "calls": e.count / a.ticks,
                          "self_cpu_ms": e.self_cpu_time_total / 1e3 / a.ticks}
                         for e in top_host],
        "top_device_ops": [{"op": e.key, "calls": e.count / a.ticks,
                            "device_ms": dev_us(e) / 1e3 / a.ticks}
                           for e in top_dev],
    }
    if on_card:
        report.update(card_info())
    print(json.dumps(report), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
