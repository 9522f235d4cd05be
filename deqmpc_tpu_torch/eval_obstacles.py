"""The obstacle protocol: closed-loop collision and success rates with
Wilson intervals.

Port of `rollout_stats`, `rollout_safety_filter`, `wilson_ci` and `main`
(`scripts/eval_obstacles.py:33-231`). A policy rolls on an obstacle field
of FlyingCartpole; an episode collides if its quadrotor enters a sphere at
any tick, and succeeds if it ends finite, collision-free and within 0.25
of the target (pole angle and position together). Four arms:
- `constrained`: the obstacle checkpoint with its solver's sphere rows
  (and, with `--obstacle_net_input`, its network reading the field);
- `unconstrained`: the same weights without the solver's rows;
- `plain`: a blind checkpoint (`--ckpt_plain`);
- `filter`: the blind policy's plan passed through a separate T_f-step
  obstacle-constrained `TrackingMPC` (rho_max 1e5, `al_iters` 4), whose
  first action is applied, or the policy's own where it is not finite.

Every tick runs the policy's cold forward (`qp_solve` on, `lastqp_solve`
off) on f32-rounded observations. JAX runs the filter arm in chunks of 256 lanes,
as the Pallas kernel's tile at T_f 15 exceeds the TPU's scoped VMEM; the
CUDA kernel has no such limit, so every lane runs at once here, and the
start states come from one generator (JAX draws each chunk's from its
own key). Every random draw comes from a `torch.Generator`.

  python -m deqmpc_tpu_torch.eval_obstacles --ckpt_obs checkpoints/flying_obstacles_aware_r5 \
      --obstacle_net_input --env FlyingCartpole_obstacles_dense --arms constrained \
      --episodes 512 --ep_len 360 [--cpu] [--out result.json]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

from . import resolve_device
from .envs import make_env
from .policies import build_policy, f32_observation
from .policies.tracking_mpc import TrackingMPC
from .solvers import ObstacleSet
from .training.train import apply_model_type_presets, build_argparser, build_obstacles
from .utils.checkpoint import checkpoint_step, load_checkpoint


def wilson_ci(k: int, n: int, z: float = 1.96):
    """95% Wilson score interval of a binomial rate, rounded to 4 places."""
    if n == 0:
        return [0.0, 1.0]
    p = k / n
    den = 1 + z * z / n
    center = (p + z * z / (2 * n)) / den
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return [round(float(center - half), 4), round(float(center + half), 4)]


def _stats(xf: np.ndarray, collided: np.ndarray, n: int) -> Dict:
    th = np.mod(xf[:, 6], 2 * np.pi)
    ang = np.abs(np.mod(th - np.pi + np.pi, 2 * np.pi) - np.pi)
    pos = np.linalg.norm(xf[:, :3], axis=-1)
    ok = np.isfinite(xf).all(-1)
    succ = (np.sqrt(ang**2 + pos**2) < 0.25) & ok & ~collided
    return {
        "collision_rate": float(collided.mean()),
        "collision_ci95": wilson_ci(int(collided.sum()), n),
        "success_rate": float(succ.mean()),
        "success_ci95": wilson_ci(int(succ.sum()), n),
        "final_dist_mean": float(np.nanmean(np.sqrt(ang**2 + pos**2))),
        "n_episodes": n,
        "n_nan": int((~ok).sum()),
    }


def _closed_loop(env, n, ep_len, seed, device, act):
    """n episodes of ep_len ticks from seeded starts, `act(x)` the action of
    a tick: (final states, collided per episode, seconds per tick)."""
    x = env.reset(torch.Generator().manual_seed(seed), n, device=device)
    collided = np.zeros(n, bool)
    tick_s = []
    with torch.inference_mode():
        for _ in range(ep_len):
            t0 = time.perf_counter()
            x, _ = env.step(x, act(x))
            collided |= env.check_collisions(x).cpu().numpy()
            tick_s.append(time.perf_counter() - t0)
    return x.cpu().numpy(), collided, tick_s


def rollout_stats(env, policy, n: int, ep_len: int, seed: int = 0) -> Dict:
    """The policy in closed loop (`eval_obstacles.py:33-67`)."""
    def act(x):
        out = policy.forward(f32_observation(policy, x), qp_solve=True, lastqp_solve=False)
        return out["trajs"][-1][2][:, 0]

    xf, collided, tick_s = _closed_loop(env, n, ep_len, seed, policy.device, act)
    return {**_stats(xf, collided, n), "tick_s_median": float(np.median(tick_s))}


def rollout_safety_filter(env, policy, n: int, ep_len: int, T_f: int = 15, al_iters: int = 4,
                          seed: int = 0) -> Dict:
    """The blind policy behind a T_f-step obstacle-constrained tracking
    filter (`eval_obstacles.py:70-131`): the policy's last plan, its last
    knot repeated to T_f, is the filter's reference."""
    device = policy.device
    obstacles = ObstacleSet(torch.as_tensor(env.obstacle_positions, dtype=torch.float64),
                            float(env.obstacle_radius))
    filt = TrackingMPC(env, T_f, al_iter=2, dtype=torch.float32, rho_max=1e5,
                       obstacles=obstacles, device=device)
    pad = T_f - policy.cfg.T

    def act(x):
        obs = f32_observation(policy, x)
        _, ns, na = policy.forward(obs, qp_solve=True, lastqp_solve=False)["trajs"][-1]
        x_ref = torch.cat([ns, ns[:, -1:].expand(-1, pad, -1)], dim=1)
        u_ref = torch.cat([na, na[:, -1:].expand(-1, pad, -1)], dim=1)
        _, us, _, _ = filt(obs, x_ref, u_ref, filt.init_state(x.shape[0]),
                           al_iters=al_iters)
        # the policy's own action where the filter failed
        ok = torch.isfinite(us[:, 0]).all(dim=-1, keepdim=True)
        return torch.where(ok, us[:, 0], na[:, 0])

    xf, collided, tick_s = _closed_loop(env, n, ep_len, seed, device, act)
    return {**_stats(xf, collided, n), "filter_T": T_f,
            "tick_s_median": float(np.median(tick_s))}


def build_argparser_obstacles() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_obs", type=str, required=True)
    p.add_argument("--ckpt_plain", type=str, default=None)
    p.add_argument("--episodes", type=int, default=512)
    p.add_argument("--ep_len", type=int, default=360)
    p.add_argument("--model_type", type=str, default="deq-mpc-nn")
    p.add_argument("--env", type=str, default="FlyingCartpole_obstacles",
                   help="obstacle env; FlyingCartpole_obstacles_dense is the discriminating "
                        "field (160 spheres r=0.4)")
    p.add_argument("--obstacle_net_input", action="store_true",
                   help="the --ckpt_obs policy reads per-knot obstacle features")
    p.add_argument("--T", type=int, default=5)
    p.add_argument("--safety_filter_T", type=int, default=0,
                   help="when >0, the 'filter' arm runs the --ckpt_plain policy through a "
                        "T_f-step obstacle-constrained TrackingMPC")
    p.add_argument("--arms", type=str, default="constrained,unconstrained,plain",
                   help="comma list of arms (any of constrained,unconstrained,plain,filter)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--out", type=str, default=None, help="also write the result JSON here")
    return p


def main(argv=None) -> Dict:
    args = build_argparser_obstacles().parse_args(argv)
    arms = set(args.arms.split(","))
    device = resolve_device("cpu" if args.cpu else "cuda")
    env = make_env(args.env)
    obstacles = build_obstacles(env)
    targs = build_argparser().parse_args(
        f"--env {args.env} --model_type {args.model_type} --T {args.T} --deq_iter 6 "
        f"--hdim 256 --bsz 128 --nq 7".split())
    targs = vars(apply_model_type_presets(targs))
    targs["obstacle_net_input"] = args.obstacle_net_input
    run = dict(n=args.episodes, ep_len=args.ep_len, seed=args.seed)

    out = {}
    if {"constrained", "unconstrained"} & arms:
        state, _ = load_checkpoint(args.ckpt_obs, device)
        step = checkpoint_step(args.ckpt_obs)
        if "constrained" in arms:
            pol = build_policy(targs, env, device, obstacles=obstacles)
            pol.model.load_state_dict(state)
            out["constrained"] = {**rollout_stats(env, pol, **run), "ckpt_step": step}
        if "unconstrained" in arms:
            # the same weights without the solver's rows; the network keeps
            # its (possibly aware) input, so the parameters are the same
            pol_unc = build_policy({**targs, "obstacle_constraints": False}, env, device,
                                   obstacles=obstacles)
            pol_unc.model.load_state_dict(state)
            out["unconstrained_same_weights"] = rollout_stats(env, pol_unc, **run)
    if args.ckpt_plain and {"plain", "filter"} & arms:
        pol_blind = build_policy({**targs, "obstacle_net_input": False}, env, device,
                                 obstacles=None)
        state_p, _ = load_checkpoint(args.ckpt_plain, device)
        pol_blind.model.load_state_dict(state_p)
        step_p = checkpoint_step(args.ckpt_plain)
        if "plain" in arms:
            out["plain_policy"] = {**rollout_stats(env, pol_blind, **run), "ckpt_step": step_p}
        if "filter" in arms and args.safety_filter_T > 0:
            out["safety_filter"] = {**rollout_safety_filter(env, pol_blind,
                                                            T_f=args.safety_filter_T, **run),
                                    "ckpt_step": step_p}
    if device.type == "cuda":
        from .training.eval import card_info

        out["device"] = card_info()
    print(json.dumps(out, indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
