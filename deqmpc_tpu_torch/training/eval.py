"""Closed-loop evaluation of a policy, cold start on every tick.

Port of `eval_policy`, `final_state_errors` and `success_dims_for_env`
(`deqmpc_tpu/training/eval.py:21-134`) for policies trained without
streaming: at each env step the policy runs a cold-start forward and
the first action of its last solve is applied. `--ckpt` names a JAX
package checkpoint (`checkpoints/rexquad_deqmpc`,
`checkpoints/pendulum_deqmpc`) or a port checkpoint written by
`training/train.py --save`. `final_dist_sem` is the standard error of the
mean final distance over episodes.

CLI (`--ep_len` defaults to the env's `_max_episode_steps`: 100 ticks for
RexQuadrotor, 200 for the pendulum, as the JAX eval runs them):
  python -m deqmpc_tpu_torch.training.eval --ckpt checkpoints/rexquad_deqmpc \
      --episodes 100 [--device cpu] [--out result.json]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..envs import make_env
from ..policies import build_policy
from ..utils.checkpoint import load_checkpoint


def final_state_errors(x_final: np.ndarray, targ: np.ndarray, env_name: str) -> np.ndarray:
    """Per-dim final-state error, the pendulum angle wrapped to [-pi, pi]."""
    err = np.asarray(x_final) - np.asarray(targ)
    if env_name.startswith("pendulum"):
        err[:, 0] = np.mod(err[:, 0] + np.pi, 2 * np.pi) - np.pi
    return err


def success_dims_for_env(env_name: str, nx: int, nq: int):
    """State dims entering the success norm: position-like ones only."""
    if env_name.startswith("pendulum"):
        return [0]
    if env_name == "rexquadrotor":
        return [0, 1, 2]
    return list(range(min(nq, nx)))


def eval_policy(args: Dict, env, policy, n_episodes: int = 32,
                ep_len: Optional[int] = None, seed: int = 0,
                device="cuda") -> Dict[str, float]:
    """Roll `n_episodes` episodes of `ep_len` ticks from seeded starts."""
    device = resolve_device(device)
    if ep_len is None:
        ep_len = env._max_episode_steps
    gen = torch.Generator().manual_seed(seed)
    x = env.reset(gen, n_episodes, device=device)
    xs, rewards, tick_s = [], [], []
    with torch.inference_mode():
        for _ in range(ep_len):
            t0 = time.perf_counter()
            u0 = policy.forward(x.float())["trajs"][-1][2][:, 0]
            x, r = env.step(x, u0)
            rewards.append(r.cpu().numpy())
            xs.append(x.cpu().numpy())  # the copy waits for the tick to finish
            tick_s.append(time.perf_counter() - t0)
    xs = np.stack(xs, axis=1)
    rewards = np.stack(rewards, axis=1)
    env_name = args.get("env", "")
    err = final_state_errors(xs[:, -1], env.targ_pos, env_name)
    final_dist = np.linalg.norm(err, axis=-1)
    finite = final_dist[np.isfinite(final_dist)]
    sem = float(np.std(finite, ddof=1) / np.sqrt(finite.size)) if finite.size > 1 else float("nan")
    nq = min(getattr(env, "nq", env.nx // 2), env.nx)
    dims = success_dims_for_env(env_name, env.nx, nq)
    success = np.linalg.norm(err[:, dims], axis=-1) < 0.25
    return {
        "mean_reward": float(np.nanmean(rewards)),
        "final_dist_mean": float(np.nanmean(final_dist)),
        "final_dist_median": float(np.nanmedian(final_dist)),
        "final_dist_sem": sem,
        "success_rate": float(np.mean(success)),
        "n_nan_episodes": int(np.sum(~np.isfinite(xs[:, -1]).all(axis=-1))),
        "tick_s_median": float(np.median(tick_s)),
    }


def card_info() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"kind": torch.cuda.get_device_name(0), "nvidia_smi": line}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--episodes", type=int, default=32)
    ap.add_argument("--ep_len", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the result JSON here")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    state, args = load_checkpoint(a.ckpt, device)
    env = make_env(args["env"])
    policy = build_policy(args, env, device)
    policy.model.load_state_dict(state)
    t0 = time.perf_counter()
    res = eval_policy(args, env, policy, n_episodes=a.episodes, ep_len=a.ep_len,
                      seed=a.seed, device=device)
    res.update(ckpt=a.ckpt, episodes=a.episodes,
               ep_len=a.ep_len or env._max_episode_steps, seed=a.seed,
               device=str(device), wall_s=time.perf_counter() - t0)
    if device.type == "cuda":
        res.update(card_info())
    print(json.dumps(res), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
