"""Training: imitation learning of a DEQ-MPC policy from expert windows.

Port of `preprocess_batch`, `make_train_step`, `validate_policy` and the
train CLI (`deqmpc_tpu/training/train.py:40-190,262-346,404,492-700`) for
the deq-mpc-deq model (configs #1 and #4 of `configs/run.sh`). One step:
the cold-start policy forward (N rounds of network -> AL solve), the
per-round loss, `backward()` (the phantom gradient through the DEQ cell,
the implicit backward of each round's last Newton solve), a clip of the
global gradient norm at 2.0 and Adam at lr 1e-3. The clip is optax's
`clip_by_global_norm`: gradients are scaled by 2/||g|| only when
||g|| >= 2, with no epsilon (`torch.nn.utils.clip_grad_norm_` adds 1e-6
to the norm, so it is not used). Adam is `torch.optim.Adam`, the same
update as `optax.adam` (b1 0.9, b2 0.999, eps 1e-8).

  python -m deqmpc_tpu_torch.training.train --env pendulum --model_type deq-mpc-deq \\
      --T 5 --deq_iter 6 --hdim 256 --bsz 128 [--max_train_steps 300 --val_every 100] \\
      [--save --name pendulum_port --models_dir ./model] [--device cpu]
  python -m deqmpc_tpu_torch.training.train --env rexquadrotor --nq 6 ... \\
      --load --models_dir checkpoints --ckpt rexquad_deqmpc

`--load` starts from a JAX-package checkpoint (through
`utils/checkpoint.params_from_jax`) or a port checkpoint (then with its
optimizer state). `--save` writes a port checkpoint to
`<models_dir>/<name>` whenever the validation loss improves. Flags of the
JAX CLI that are not ported raise NotImplementedError.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from .. import utils
from ..data import get_gt_data, merge_gt_data, sample_trajectory
from ..envs import make_env
from ..policies import build_policy, compute_loss_deqmpc
from ..utils.checkpoint import (is_port_checkpoint, load_checkpoint, read_port_checkpoint,
                                save_checkpoint)

MAX_GRAD_NORM = 2.0  # `train.py:560`


# -- data ---------------------------------------------------------------------

def unnormalize_for_env(env_name: str, x: np.ndarray) -> np.ndarray:
    if env_name.startswith("pendulum"):
        return utils.unnormalize_states_pendulum(x)
    if "cartpole" in env_name and "Flying" not in env_name:
        return utils.unnormalize_states_cartpole_nlink(x)
    if "FlyingCartpole" in env_name:
        return utils.unnormalize_states_flyingcartpole(x)
    return x


def preprocess_batch(env_name: str, nx: int, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Angle convention shift of states and observations, then the window
    unwrap of the target states (host side, numpy)."""
    batch["state"] = np.asarray(unnormalize_for_env(env_name, batch["state"]))
    batch["obs"] = np.asarray(unnormalize_for_env(env_name, batch["obs"]))
    batch["state"] = utils.unwrap_angle_windows(batch["state"],
                                                utils.angle_idxs_for_env(env_name, nx))
    return batch


def split_episodes(gt_trajs: List):
    """The 90/10 train/validation split of the episodes (`train.py:535-536`):
    (train arrays, validation arrays)."""
    n_train = round(len(gt_trajs) * 0.9)
    val_trajs = gt_trajs[round(-len(gt_trajs) * 0.1):]
    return merge_gt_data(gt_trajs, num_trajs=n_train), merge_gt_data(val_trajs)


def to_device(batch: Dict[str, np.ndarray], device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in batch.items()}


# -- step -----------------------------------------------------------------------

def loss_fn(policy, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The forward and the loss of one batch (`make_train_step.loss_fn`)."""
    obs = batch["obs"][:, -1] if batch["obs"].dim() == 3 else batch["obs"]
    policy_out = policy.forward(obs)
    return compute_loss_deqmpc(policy, batch["state"], batch["action"], batch["mask"],
                               policy_out, x_init=policy_out["init_states"])


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float = MAX_GRAD_NORM) -> torch.Tensor:
    """Scale the gradients in place as optax.clip_by_global_norm does:
    g -> g / ||g|| * max_norm when ||g|| >= max_norm. Parameters without a
    gradient count as zeros. Returns the norm before clipping; no host
    sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def make_optimizer(policy, lr: float = 1e-3) -> torch.optim.Optimizer:
    return torch.optim.Adam(policy.model.parameters(), lr=lr)


def train_step(policy, optimizer, batch: Dict[str, torch.Tensor],
               timings: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """One training step: forward and loss, backward, clip, Adam. Returns
    the loss, loss_end and the gradient norm before clipping as device
    tensors. With `timings`, the device is synchronised after each part and
    its host-clock seconds are stored under forward_s, backward_s and
    optimizer_s."""
    sync = (torch.cuda.synchronize if timings is not None and batch["obs"].is_cuda
            else (lambda: None))
    t0 = time.perf_counter()
    optimizer.zero_grad(set_to_none=True)
    d = loss_fn(policy, batch)
    sync()
    t1 = time.perf_counter()
    d["loss"].backward()
    sync()
    t2 = time.perf_counter()
    gnorm = clip_by_global_norm_(list(policy.model.parameters()))
    optimizer.step()
    sync()
    if timings is not None:
        timings.update(forward_s=t1 - t0, backward_s=t2 - t1,
                       optimizer_s=time.perf_counter() - t2)
    return {"loss": d["loss"].detach(), "loss_end": d["loss_end"].detach(), "grad_norm": gnorm}


def validate_policy(policy, val_samples: List[Dict[str, torch.Tensor]]) -> float:
    """Mean over the validation batches of loss_end (`train.py:404`)."""
    with torch.inference_mode():
        return float(np.mean([float(loss_fn(policy, b)["loss_end"]) for b in val_samples]))


# -- CLI ------------------------------------------------------------------------

# the JAX CLI's model types; all but deq-mpc-deq raise NotImplementedError
MODEL_TYPES = ["deq-mpc-deq", "deq", "nn", "diff-mpc-deq", "diff-mpc-nn", "deq-mpc-nn"]


def build_argparser() -> argparse.ArgumentParser:
    """The flags of the JAX CLI that the port takes."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env", type=str, default="pendulum")
    p.add_argument("--model_type", type=str, default="deq-mpc-deq", choices=MODEL_TYPES)
    p.add_argument("--nq", type=int, default=-1)
    p.add_argument("--T", type=int, default=5)
    p.add_argument("--deq_iter", type=int, default=6)
    p.add_argument("--hdim", type=int, default=128)
    p.add_argument("--bsz", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_train_steps", type=int, default=20000)
    p.add_argument("--val_every", type=int, default=100)
    p.add_argument("--save", action="store_true")
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--models_dir", type=str, default="./model")
    p.add_argument("--load", action="store_true")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    args, rest = build_argparser().parse_known_args(argv)
    if rest:
        raise NotImplementedError(f"flags not ported yet: {' '.join(rest)}")
    if args.model_type != "deq-mpc-deq":
        raise NotImplementedError(f"model_type={args.model_type!r} is not ported yet")
    # the deq-mpc-deq preset (`train.py:108-139`) and the JAX CLI's
    # defaults of the flags the port does not take
    vars(args).update(
        deq=True, qp_solve=True, lastqp_solve=False, dtype="float32", rho_max=None,
        layer_type="gcn", kernel_width=3, m=5, max_steps=10, deq_reg=0.1, loss_type="l1",
        policy_out_type=1, deq_out_type=1, fp_type="anderson", grad_type="fp_grad",
        streaming=False)
    return args


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    env = make_env(args.env)
    if args.nq <= 0:
        args.nq = env.nq if env.nq <= env.nx // 2 else env.nx // 2
    gt, val_gt = split_episodes(get_gt_data(env))
    rng = np.random.default_rng(args.seed)
    # windows of a one-step history (H = 1): the policy sees the current state
    val_samples = [to_device(preprocess_batch(args.env, env.nx,
                                              sample_trajectory(val_gt, args.bsz, 1, args.T, rng)),
                             device)
                   for _ in range(10)]
    policy = build_policy(vars(args), env, device).init(args.seed)
    optimizer = make_optimizer(policy, args.lr)
    if args.load and args.ckpt:
        path = os.path.join(args.models_dir, args.ckpt)
        state, _ = load_checkpoint(path, device)
        policy.model.load_state_dict(state)
        opt_state = read_port_checkpoint(path)["optimizer"] if is_port_checkpoint(path) else None
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
    name = args.name or (f"{args.model_type}_{args.env}_T{args.T}_bsz{args.bsz}"
                         f"_deq_iter{args.deq_iter}_hdim{args.hdim}")
    ckpt_path = os.path.join(args.models_dir, name)

    best_val, curve = np.inf, []
    losses, losses_end = [], []
    t_window = time.perf_counter()
    for i in range(args.max_train_steps):
        batch = preprocess_batch(args.env, env.nx,
                                 sample_trajectory(gt, args.bsz, 1, args.T, rng))
        out = train_step(policy, optimizer, to_device(batch, device))
        losses.append(out["loss"])
        losses_end.append(out["loss_end"])
        if i % args.val_every != 0:
            continue
        if not np.isfinite(float(out["loss"])):
            print(f"[{i}] non-finite loss, stopping", flush=True)
            break
        val = validate_policy(policy, val_samples)
        row = {"step": i,
               "loss_avg": float(torch.stack(losses).mean()) / args.deq_iter,
               "loss_end": float(torch.stack(losses_end).mean()),
               "val_loss_end": val, "grad_norm": float(out["grad_norm"]),
               "s_per_step": (time.perf_counter() - t_window) / len(losses)}
        curve.append(row)
        print(json.dumps(row), flush=True)
        if args.save and val < best_val:
            best_val = val
            save_checkpoint(ckpt_path, policy.model, optimizer, i, vars(args))
        losses, losses_end = [], []
        t_window = time.perf_counter()
    result = {"env": args.env, "steps": args.max_train_steps, "bsz": args.bsz,
              "hdim": args.hdim, "deq_iter": args.deq_iter, "device": str(device),
              "curve": curve, "checkpoint": ckpt_path if args.save else None}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
