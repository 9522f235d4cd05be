"""Warm-start an obstacle-aware flying policy from the blind one.

Port of `scripts/warmstart_obstacle_aware.py`. The aware network reads
each knot's 4 nearest spheres as 16 more input channels of the
`ConvInput` concat, so `Conv_0`'s kernel (k, Cin, Cout) gains 16 input
rows and the blind checkpoint no longer loads. Zero-padding exactly those
rows makes the aware network equal to the blind one at init (checked:
their network proposals within 1e-5 on 4 start states), so training only
has to learn the obstacle response. Every other parameter has the same
shape and is copied. The result is written as a port checkpoint.

    python -m deqmpc_tpu_torch.warmstart_obstacle_aware \\
        --src checkpoints/flying_deqmpc_nn --dst model/flying_obstacles_aware_warm

`--src` is a JAX-package or a port checkpoint; `--hdim` (256, the
configuration's width) must be its width.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .envs import make_env
from .policies import build_policy
from .training import train
from .utils.checkpoint import checkpoint_step, load_checkpoint, save_checkpoint

BASE = "--model_type deq-mpc-nn --T 5 --deq_iter 6 --bsz 128 --nq 7".split()
INIT_TOL = 1e-5


def merge(aware: Dict[str, torch.Tensor], blind: Dict[str, torch.Tensor]
          ) -> Tuple[Dict[str, torch.Tensor], int, List[Tuple[str, tuple, tuple]]]:
    """The aware state dict with every blind leaf of the same shape copied
    and a kernel that gained input rows (axis 1) zero-padded; a leaf the
    blind network lacks keeps its aware init. Returns (merged, copied,
    padded as (name, blind shape, aware shape)); any other change of shape
    raises."""
    out, copied, padded = {}, 0, []
    for key, v in aware.items():
        if key not in blind:
            out[key] = v
            continue
        b = blind[key].to(v.device, v.dtype)
        if b.shape == v.shape:
            out[key] = b
            copied += 1
        elif (b.ndim == v.ndim == 3 and b.shape[0] == v.shape[0]
              and b.shape[2] == v.shape[2] and v.shape[1] > b.shape[1]):
            pad = torch.zeros((b.shape[0], v.shape[1] - b.shape[1], b.shape[2]),
                              dtype=b.dtype, device=b.device)
            out[key] = torch.cat([b, pad], dim=1)
            padded.append((key, tuple(b.shape), tuple(v.shape)))
        else:
            raise SystemExit(f"unhandled shape change at {key}: {tuple(b.shape)} -> "
                             f"{tuple(v.shape)}")
    return out, copied, padded


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="checkpoints/flying_deqmpc_nn")
    ap.add_argument("--dst", default="model/flying_obstacles_aware_warm")
    ap.add_argument("--env", default="FlyingCartpole_obstacles_dense")
    ap.add_argument("--hdim", type=int, default=256, help="the blind checkpoint's width")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    device = args.device
    env = make_env(args.env)
    width = ["--hdim", str(args.hdim)]
    targs = vars(train.parse_args(["--env", args.env, *BASE, *width]))
    targs["obstacle_net_input"] = True
    pol_aware = build_policy(targs, env, device, obstacles=train.build_obstacles(env))
    bargs = vars(train.parse_args(["--env", "FlyingCartpole", *BASE, *width]))
    pol_blind = build_policy(bargs, make_env("FlyingCartpole"), device)
    blind, _ = load_checkpoint(args.src, device)
    pol_blind.model.load_state_dict(blind)

    merged, copied, padded = merge(pol_aware.model.state_dict(), blind)
    pol_aware.model.load_state_dict(merged)
    print(f"copied {copied} leaves; zero-padded {padded}")

    # the aware network at init with zeroed obstacle rows is the blind one
    obs = torch.as_tensor(np.random.default_rng(0).uniform(-0.2, 0.2, (4, env.nx)),
                          dtype=torch.float32, device=device)
    with torch.inference_mode():
        pa = pol_aware.forward(obs, qp_solve=False)
        pb = pol_blind.forward(obs, qp_solve=False)
    d = float(torch.max(torch.abs(pa["trajs"][-1][0] - pb["trajs"][-1][0])))
    print(f"max |aware(init) - blind| network proposal: {d:.2e}")
    if not d < INIT_TOL:
        raise SystemExit("warm start is not behavior-preserving")

    step = checkpoint_step(args.src)
    save_checkpoint(args.dst, pol_aware.model, None, step, targs)
    print(f"wrote {args.dst} (from {args.src} step {step})")
    return {"copied": copied, "padded": padded, "init_gap": d, "step": step}


if __name__ == "__main__":
    main()
