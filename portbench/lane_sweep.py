"""The lane sweep: one closed-loop tick of a checkpoint at several lane counts.

For each lane count: one warm-up tick, one tick timed by the host clock to a
sync, then one tick under torch.profiler (after one tick in its warm-up step).
Reports the tick's wall time, the device's busy union and idle share over the
profiled tick, the kernels launched, the Newton steps and retries, and the
peak device memory. Runs on the card only.

  python portbench/lane_sweep.py --ckpt checkpoints/rexquad_deqmpc --lanes 1024 4096 16384 \
      [--out chiprun_out/lane_sweep.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--lanes", type=int, nargs="+", default=[1024, 4096, 16384])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("lane_sweep: no CUDA device")
    from torch.profiler import ProfilerActivity, profile, schedule

    from deqmpc_tpu_torch.envs import make_env_of
    from deqmpc_tpu_torch.policies import build_policy
    from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint

    state, args = load_checkpoint(str(ROOT / a.ckpt), "cuda")
    env = make_env_of(args)
    policy = build_policy(args, env, "cuda")
    policy.model.load_state_dict(state)
    rows = []
    for lanes in a.lanes:
        x = env.reset(torch.Generator().manual_seed(a.seed), lanes, device="cuda")

        def tick(x):
            u0 = policy.forward(x.float())["trajs"][-1][2][:, 0]
            return env.step(x, u0)[0]

        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            x = tick(x)
            torch.cuda.synchronize()
            s0, r0 = policy.newton_steps, policy.newton_retries
            t = time.perf_counter()
            x = tick(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            steps, retries = policy.newton_steps - s0, policy.newton_retries - r0
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                x = tick(x)
                torch.cuda.synchronize()
                prof.step()
                t = time.perf_counter()
                x = tick(x)
                torch.cuda.synchronize()
                traced_wall = time.perf_counter() - t
                prof.step()
        kernels = harness.device_intervals(harness.kineto_events(prof))
        busy = harness.union_seconds(kernels)
        row = {"lanes": lanes, "tick_s": wall, "newton_steps": steps, "retries": retries,
               "traced_tick_s": traced_wall, "busy_s": busy,
               "idle_share": 1.0 - busy / traced_wall, "kernels": len(kernels),
               "memory_peak_bytes": torch.cuda.max_memory_allocated()}
        print(json.dumps(row), flush=True)
        rows.append(row)
    out = {"ckpt": a.ckpt, "device": harness.device_info(1), "rows": rows}
    print(json.dumps(out), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
