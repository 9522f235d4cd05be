"""Closed-loop evaluation of a policy.

Port of `eval_policy`, `final_state_errors` and `success_dims_for_env`
(`deqmpc_tpu/training/eval.py:21-134`): at each env step the policy runs
a forward and the first action of its last solve is applied. Tick 0 is a
cold start; with `warm_start` (by default iff the checkpoint was trained
with `streaming`, as in JAX) every later tick is `forward_warm_start`
from the carry of the tick before, else a cold start again. The JSON
gives tick 0's time (`tick_s_cold`) apart from the median of the warm
ticks (`tick_s_warm_median`). `--ckpt` names a JAX
package checkpoint (`checkpoints/rexquad_deqmpc`,
`checkpoints/pendulum_deqmpc`) or a port checkpoint written by
`training/train.py --save`. `final_dist_sem` is the standard error of the
mean final distance over episodes. The final-state error wraps every
angle dim of the env (`utils.angle_idxs_for_env`), and success is judged
on the env's position-like dims, both as in JAX. For an env with
obstacles the CLI gives the policy the field (`train.build_obstacles`)
and the JSON adds `collision_rate`, the share of episodes that entered a
sphere at some tick. The policy takes the checkpoint's `qp_solve`,
`lastqp_solve` and `solver_type` (`eval.py:84-99`), so a diff-mpc
checkpoint is served with its final solve; `--solver_type ip` serves the
same weights through the interior-point solve (JAX's `train.py --eval
--solver_type ip`). The policy variants are served where JAX's
`eval_policy` serves them (`eval.py:51-130`): those whose forward takes
the current state alone (mem, delta, feedback, q, and history at H = 1);
estpred, which also reads the history's actions, and a history of more
than one state are refused. An obstacle-aware checkpoint
(`obstacle_net_input`, `checkpoints/flying_obstacles_aware_r5`) reads the
env's field in its network as well as in its solver. The checkpoint's
args build the policy and the env whatever options they carry (the fixed
point, `recompute_Qq`, `compute_dtype`, a FlyingCartpole's `Qscale`);
`--recompute_Qq` turns the cost refresh on for weights trained without it.
The args' `eval_x_window` (a comma string or an array of per-dim
half-widths in Euler space) replaces the env's start window, for the envs
whose `reset` takes one (RexQuadrotor, FlyingCartpole); any other env
raises, as in JAX (`eval.py:66-80`). `check_param_sensitivity`
(`eval.py:137-169`) gives the imitation loss of the policy's parameters and
of each set moved by `s * std * N(0, 1)` per floating tensor, the draws from
a seeded `torch.Generator`; `perturb_params` makes one such set and
`param_set_loss` evaluates any set on its own.

CLI (`--ep_len` defaults to the env's `_max_episode_steps`: 100 ticks for
RexQuadrotor and FlyingCartpole, 200 for the pendulum and the cartpole, as
the JAX eval runs them; the FlyingCartpole rows of `PARITY.md` were taken
at `--ep_len 360`):
  python -m deqmpc_tpu_torch.training.eval --ckpt checkpoints/rexquad_deqmpc \
      --episodes 100 [--device cpu] [--out result.json]
  python -m deqmpc_tpu_torch.training.eval --ckpt checkpoints/flying_deqmpc_nn \
      --episodes 100 --ep_len 360
  python -m deqmpc_tpu_torch.training.eval --ckpt checkpoints/pendulum_diffmpc_deq --episodes 100
  python -m deqmpc_tpu_torch.training.eval --ckpt checkpoints/pendulum_deqmpc --solver_type ip
  python -m deqmpc_tpu_torch.training.eval --ckpt checkpoints/rexquad_deqmpc --recompute_Qq
  python -m deqmpc_tpu_torch.training.eval --ckpt checkpoints/flying_obstacles_aware_r5 \
      --episodes 64 --ep_len 360
  python -m deqmpc_tpu_torch.training.eval --ckpt checkpoints/cartpole_deqmpc --episodes 100
  python -m deqmpc_tpu_torch.training.eval --ckpt checkpoints/pendulum_sac_deqmpc --episodes 100
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..envs import make_env_of
from ..policies import build_policy, compute_loss_deqmpc
from ..utils import angle_idxs_for_env
from ..utils.checkpoint import load_checkpoint
from .train import build_obstacles


def final_state_errors(x_final: np.ndarray, targ: np.ndarray, env_name: str,
                       nx: Optional[int] = None) -> np.ndarray:
    """Per-dim final-state error, the env's angle dims wrapped to [-pi, pi]
    (`eval.py:21-32`)."""
    err = np.asarray(x_final) - np.asarray(targ)
    idxs = angle_idxs_for_env(env_name, err.shape[-1] if nx is None else nx)
    for i in (idxs if idxs is not None else ()):
        err[:, i] = np.mod(err[:, i] + np.pi, 2 * np.pi) - np.pi
    return err


def success_dims_for_env(env_name: str, nx: int, nq: int):
    """State dims entering the success norm: position-like ones only
    (`eval.py:35-47`)."""
    if env_name.startswith("pendulum"):
        return [0]                      # pole angle
    if "cartpole" in env_name and "Flying" not in env_name:
        return list(range(nq))          # cart position and joint angles
    if env_name == "rexquadrotor":
        return [0, 1, 2]                # world position
    if "FlyingCartpole" in env_name:
        return [0, 1, 2, 6]             # quad position and pole angle
    return list(range(min(nq, nx)))


def eval_policy(args: Dict, env, policy, n_episodes: int = 32,
                ep_len: Optional[int] = None, seed: int = 0,
                device="cuda", warm_start: Optional[bool] = None) -> Dict[str, float]:
    """Roll `n_episodes` episodes of `ep_len` ticks from seeded starts;
    `warm_start` None means `args["streaming"]`."""
    device = resolve_device(device)
    if policy.takes_action_history or getattr(policy, "H", 1) > 1:
        raise NotImplementedError("the closed loop gives the policy the current state alone: "
                                  "estpred and histories of H > 1 are not served (as in JAX)")
    if ep_len is None:
        ep_len = env._max_episode_steps
    if warm_start is None:
        warm_start = bool(args.get("streaming", False))
    gen = torch.Generator().manual_seed(seed)
    x_window = args.get("eval_x_window")
    if x_window is not None:
        import inspect

        if "x_window" not in inspect.signature(env.reset).parameters:
            raise ValueError(f"--eval_x_window is not supported by {type(env).__name__}.reset "
                             "(only FlyingCartpole/RexQuadrotor take a start-window override)")
        x_window = (np.asarray([float(v) for v in x_window.split(",")])
                    if isinstance(x_window, str) else np.asarray(x_window))
        x = env.reset(gen, n_episodes, device=device, x_window=x_window)
    else:
        x = env.reset(gen, n_episodes, device=device)
    xs, rewards, tick_s = [], [], []
    with torch.inference_mode():
        for t in range(ep_len):
            t0 = time.perf_counter()
            if t > 0 and warm_start:
                out = policy.forward_warm_start(x.float(), out["carry"])
            else:
                out = policy.forward(x.float())
            u0 = out["trajs"][-1][2][:, 0]
            x, r = env.step(x, u0)
            rewards.append(r.cpu().numpy())
            xs.append(x.cpu().numpy())  # the copy waits for the tick to finish
            tick_s.append(time.perf_counter() - t0)
    xs = np.stack(xs, axis=1)
    rewards = np.stack(rewards, axis=1)
    env_name = args.get("env", "")
    err = final_state_errors(xs[:, -1], env.targ_pos, env_name, env.nx)
    final_dist = np.linalg.norm(err, axis=-1)
    finite = final_dist[np.isfinite(final_dist)]
    sem = float(np.std(finite, ddof=1) / np.sqrt(finite.size)) if finite.size > 1 else float("nan")
    nq = min(getattr(env, "nq", env.nx // 2), env.nx)
    dims = success_dims_for_env(env_name, env.nx, nq)
    success = np.linalg.norm(err[:, dims], axis=-1) < 0.25
    collision = {}
    if getattr(env, "obstacles", False):
        hit = env.check_collisions(torch.as_tensor(xs)).any(dim=1)
        collision["collision_rate"] = float(hit.double().mean())
    return {
        "mean_reward": float(np.nanmean(rewards)),
        "final_dist_mean": float(np.nanmean(final_dist)),
        "final_dist_median": float(np.nanmedian(final_dist)),
        "final_dist_sem": sem,
        "success_rate": float(np.mean(success)),
        "n_nan_episodes": int(np.sum(~np.isfinite(xs[:, -1]).all(axis=-1))),
        "tick_s_median": float(np.median(tick_s)),
        "warm_start": warm_start,
        "tick_s_cold": tick_s[0],
        "tick_s_warm_median": float(np.median(tick_s[1:])) if warm_start and ep_len > 1 else None,
        **collision,
    }


def _batch_tensors(gt_batch: Mapping, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=device)
            for k, v in gt_batch.items()}


def param_set_loss(args: Mapping, policy, gt_batch: Mapping,
                   state: Optional[Mapping[str, torch.Tensor]] = None) -> float:
    """The imitation loss (`compute_loss_deqmpc`, no x_init, as JAX's
    `loss_of`) of the policy's cold forward on the batch's current states,
    with the parameter set `state` in place of the policy's own (restored
    after); the batch keeps its dtype."""
    b = _batch_tensors(gt_batch, policy.device)
    obs = b["obs"][:, -1] if b["obs"].dim() == 3 else b["obs"]
    mode = dict(qp_solve=args.get("qp_solve", True), lastqp_solve=args.get("lastqp_solve", False))
    own = None
    if state is not None:
        own = {k: v.clone() for k, v in policy.model.state_dict().items()}
        policy.model.load_state_dict(state)
    try:
        with torch.inference_mode():
            out = policy.forward(obs, **mode)
            d = compute_loss_deqmpc(policy, b["state"], b["action"], b["mask"], out)
            return float(d["loss"])
    finally:
        if own is not None:
            policy.model.load_state_dict(own)


def perturb_params(state: Mapping[str, torch.Tensor], scale: float,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every floating tensor t moved by scale * std(t) * N(0, 1) (population
    std), the draws made on the CPU in t's dtype, tensor by tensor in the
    state's order; other tensors as they are."""
    out = {}
    for k, t in state.items():
        if t.is_floating_point():
            z = torch.randn(t.shape, generator=generator, dtype=t.dtype).to(t.device)
            out[k] = t + scale * torch.std(t, correction=0) * z
        else:
            out[k] = t
    return out


def check_param_sensitivity(args: Mapping, env, policy, gt_batch: Mapping,
                            scales: Sequence[float] = (0.01, 0.03, 0.1),
                            seed: int = 0) -> Dict[str, float]:
    """The base loss and, for each scale s, the loss with every floating
    parameter moved by s * std * N(0, 1) (`eval.py:137-169`): {"base_loss",
    "loss_at_<s>"}. One generator, seeded once, draws the scales' sets in turn."""
    gen = torch.Generator().manual_seed(seed)
    state = {k: v.detach().clone() for k, v in policy.model.state_dict().items()}
    out = {"base_loss": param_set_loss(args, policy, gt_batch)}
    for s in scales:
        out[f"loss_at_{s}"] = param_set_loss(args, policy, gt_batch,
                                             perturb_params(state, s, gen))
    return out


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
    ap.add_argument("--solver_type", choices=["al", "ip"], default=None,
                    help="the tracking solve, in place of the checkpoint's")
    ap.add_argument("--recompute_Qq", action="store_true",
                    help="refresh the tracking cost from the network between AL iterations")
    ap.add_argument("--out", default=None, help="also write the result JSON here")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    state, args = load_checkpoint(a.ckpt, device)
    if a.solver_type is not None:
        args["solver_type"] = a.solver_type
    if a.recompute_Qq:
        args["recompute_Qq"] = True
    env = make_env_of(args)
    policy = build_policy(args, env, device, obstacles=build_obstacles(env))
    policy.model.load_state_dict(state)
    t0 = time.perf_counter()
    res = eval_policy(args, env, policy, n_episodes=a.episodes, ep_len=a.ep_len,
                      seed=a.seed, device=device)
    res.update(ckpt=a.ckpt, episodes=a.episodes,
               ep_len=a.ep_len or env._max_episode_steps, seed=a.seed,
               model_type=args.get("model_type"), solver_type=args.get("solver_type", "al"),
               recompute_Qq=args.get("recompute_Qq", False),
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
