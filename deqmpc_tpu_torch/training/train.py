"""Training: imitation learning of a DEQ-MPC policy from expert windows.

Port of `apply_model_type_presets`, `preprocess_batch`, `make_train_step`,
`make_streaming_train_step`, `validate_policy` and the train CLI
(`deqmpc_tpu/training/train.py:40-190,247-260,262-398,404,492-700`) for
every model type of the JAX CLI (deq-mpc-deq, deq-mpc-nn, deq, nn,
diff-mpc-deq, diff-mpc-nn; configs #1-#5 of `configs/run.sh` and the
diff-mpc arms) and both solvers (`--solver_type al|ip`); the obstacle env
of #3b gets the solver's sphere rows from `build_obstacles`. One step:
the cold-start policy forward (N rounds of network -> AL solve), the
per-round loss, `backward()` (the phantom gradient through the DEQ cell,
the implicit backward of each round's last Newton solve), a clip of the
global gradient norm at 2.0 and Adam at lr 1e-3. A streaming step
(`--streaming`, config #5) runs the cold forward on the window's first
state and then `--streaming_steps` L warm-started forwards on states
1..L, each from the carry of the one before, and sums the L+1 losses;
its batches are windows of T + L states. The clip is optax's
`clip_by_global_norm`: gradients are scaled by 2/||g|| only when
||g|| >= 2, with no epsilon (`torch.nn.utils.clip_grad_norm_` adds 1e-6
to the norm, so it is not used). Adam is `torch.optim.Adam`, the same
update as `optax.adam` (b1 0.9, b2 0.999, eps 1e-8). The model type sets
the forward's `qp_solve` and `lastqp_solve` (`apply_model_type_presets`);
with `--pretrain` the first PRETRAIN_STEPS steps run the network alone
(both off), as JAX's gate does (`train.py:612-633`).

The policy variants (`--policy_variant mem|delta|history|estpred|feedback|q`,
`--addmem`, `--layer_type mlp`, `--deq_out_type 2`, `--H`,
`--obstacle_net_input`; `train.py:297-330,655-664`): the history variants
read batches of H-step histories (`obs` (bsz, H, nx)), estpred also their
actions (`obs_action`) and its loss logs the state-estimate losses; after
each Adam step of the delta variant its `scales`, which Adam has just
updated with their straight-through gradient, are overwritten by the EMA
of the rounds' median errors (`models/grad_layers.update_scales`), in
that order.

  python -m deqmpc_tpu_torch.training.train --env pendulum --model_type deq-mpc-deq \\
      --T 5 --deq_iter 6 --hdim 256 --bsz 128 [--max_train_steps 300 --val_every 100] \\
      [--save --name pendulum_port --models_dir ./model] [--device cpu]
  python -m deqmpc_tpu_torch.training.train --env rexquadrotor --nq 6 ... \\
      --load --models_dir checkpoints --ckpt rexquad_deqmpc
  python -m deqmpc_tpu_torch.training.train --env cartpole1link --T 10 --nq 2 --teacher sac ... \\
      --load --models_dir checkpoints --ckpt cartpole_sac_deqmpc
  python -m deqmpc_tpu_torch.training.train --env FlyingCartpole --model_type deq-mpc-nn \\
      --nq 7 ... --load --models_dir checkpoints --ckpt flying_deqmpc_nn
  python -m deqmpc_tpu_torch.training.train --env rexquadrotor --nq 6 ... \\
      --streaming --streaming_steps 2 --load --models_dir checkpoints --ckpt rexquad_streaming
  python -m deqmpc_tpu_torch.training.train --env FlyingCartpole --model_type diff-mpc-deq \\
      --nq 7 --T 5 --hdim 256 --load --models_dir checkpoints --ckpt flying_diffmpc_deq
  python -m deqmpc_tpu_torch.training.train --env pendulum --solver_type ip --T 5 \\
      --deq_iter 6 --hdim 256 --bsz 128 [--qp_iter 1 --eps 1e-2 --ip_grad_method analytic]
  python -m deqmpc_tpu_torch.training.train --env pendulum --policy_variant estpred --H 3 \\
      --T 5 --deq_iter 6 --hdim 256 --bsz 128 [--save --name estpred_port]
  python -m deqmpc_tpu_torch.training.train --env rexquadrotor --nq 6 ... \\
      --load --models_dir checkpoints --ckpt rexquad_deqmpc --grad_type implicit \\
      [--recompute_Qq] [--fp_type broyden|multi --inner_deq_iters 4 --m 5 --max_steps 10] \\
      [--compute_dtype bf16] [--grad_coeff] [--Qscale 2 (FlyingCartpole)]
  python -m deqmpc_tpu_torch.training.train ... --load --ckpt X --eval \\
      [--eval_episodes 32 --eval_ep_len 100 --eval_warm_start auto|on|off]

The fixed point, the cost refresh and the trunk's dtype (`train.py:77,101,
109-116,137,203-215`): `--fp_type`, `--inner_deq_iters`, `--grad_type` (a
free string, as in JAX), `--m`, `--max_steps`, `--recompute_Qq` and
`--compute_dtype f32|bf16` go to `build_policy`; `--Qscale` scales the
FlyingCartpole's velocity weights (the env of the FlyingCartpole names
only, as JAX's `train.py:520`). Each validation row logs the rounds'
`deq_stats` (the solver's mean best error and step) when the network runs
a solver. `--grad_coeff` (`train.py:673-685`): the loss coefficients,
(deq_iter, 3) ones at the start, are updated every `--val_every` steps
after the step, on the same batch and outside streaming, by the EMA of the
rounds' gradient ratios at the output head (`training/grad_coeffs.py`);
the step's loss and validation take them.

`--load` starts from a JAX-package checkpoint (through
`utils/checkpoint.params_from_jax`) or a port checkpoint (then with its
optimizer state). `--save` writes a port checkpoint to
`<models_dir>/<name>` whenever the validation loss improves. Flags of the
JAX CLI that are not ported raise NotImplementedError.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from .. import utils
from ..data import get_gt_data, merge_gt_data, sample_trajectory
from ..envs import make_env_of
from ..models.grad_layers import update_scales
from ..policies import build_policy, compute_loss_deqmpc, compute_loss_deqmpc_hist
from ..policies.deqmpc_policy import POLICY_VARIANTS
from .grad_coeffs import compute_grad_ratio_coeffs, update_coeffs_ema
from ..solvers import ObstacleSet
from ..utils.checkpoint import (is_port_checkpoint, load_checkpoint, read_port_checkpoint,
                                save_checkpoint)

MAX_GRAD_NORM = 2.0  # `train.py:560`
PRETRAIN_STEPS = 5000  # network-only steps under --pretrain (`train.py:612`)


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


def build_obstacles(env) -> Optional[ObstacleSet]:
    """The env's obstacle field as the solver takes it (`train.py:247-260`),
    centers (N, 3) in f64 on the CPU; None for an env without obstacles."""
    if not getattr(env, "obstacles", False):
        return None
    return ObstacleSet(torch.as_tensor(env.obstacle_positions, dtype=torch.float64),
                       float(env.obstacle_radius))


def to_device(batch: Dict[str, np.ndarray], device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in batch.items()}


# -- step -----------------------------------------------------------------------

def _window(batch, start: int, T: int):
    return (batch["state"][:, start:start + T], batch["action"][:, start:start + T],
            batch["mask"][:, start:start + T])


def _cold_forward(policy, batch, coeffs=None, **mode):
    obs = batch["obs"]
    if not policy.takes_history and obs.dim() == 3:
        obs = obs[:, -1]
    window = _window(batch, 0, policy.T)
    if policy.takes_action_history:
        policy_out = policy.forward(obs, batch["obs_action"], **mode)
        d = compute_loss_deqmpc_hist(policy, window[0], window[1], batch["obs"], window[2],
                                     policy_out, coeffs=coeffs, x_init=policy_out["init_states"])
    else:
        policy_out = policy.forward(obs, **mode)
        d = compute_loss_deqmpc(policy, *window, policy_out, coeffs=coeffs,
                                x_init=policy_out["init_states"])
    if "deq_stats" in policy_out:
        d["deq_stats"] = {k: v.detach() for k, v in policy_out["deq_stats"].items()}
    if policy.is_delta:
        # what the trainer's EMA of the output scales reads (`train.py:316-323`)
        d["opt_states"] = torch.stack([t[1] for t in policy_out["trajs"]]).detach()
        d["init_states"] = policy_out["init_states"].detach()
    return policy_out, d


def loss_fn(policy, batch: Dict[str, torch.Tensor], coeffs=None,
            **mode) -> Dict[str, torch.Tensor]:
    """The forward and the loss of one batch (`make_train_step.loss_fn`),
    on the first T states of its windows (a history variant's forward
    reads the window's history, estpred's also its actions), with the
    rounds' loss `coeffs` (deq_iter, 3) (None: ones). `mode`: the
    forward's `qp_solve`/`lastqp_solve`, by default the policy's."""
    return _cold_forward(policy, batch, coeffs, **mode)[1]


def streaming_loss_fn(policy, batch: Dict[str, torch.Tensor], steps: int,
                      coeffs=None) -> Dict[str, torch.Tensor]:
    """The streaming forward and loss (`make_streaming_train_step.loss_fn`):
    the cold forward's loss on states 0..T-1, then for l = 1..`steps` a
    warm-started forward from state l and the previous carry, with its loss
    on states l..l+T-1; the losses summed, loss_end their mean, the
    per-round losses the last forward's. As in JAX, every forward takes the
    policy's `qp_solve` and no final solve, and only the cold loss takes
    `coeffs`."""
    mode = dict(lastqp_solve=False)
    policy_out, d = _cold_forward(policy, batch, coeffs, **mode)
    total, loss_ends = d["loss"], [d["loss_end"]]
    for l in range(1, steps + 1):
        policy_out = policy.forward_warm_start(batch["state"][:, l], policy_out["carry"], **mode)
        d = compute_loss_deqmpc(policy, *_window(batch, l, policy.T), policy_out)
        total = total + d["loss"]
        loss_ends.append(d["loss_end"])
    return {**d, "loss": total, "loss_end": torch.stack(loss_ends).mean()}


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


def make_loss_fn(streaming_steps: int = 0, pretrain: bool = False) -> Callable:
    """`loss_fn`; with streaming_steps L > 0 the streaming loss of L warm
    forwards; with `pretrain` the network-only loss (no solve, no final
    solve: `make_train_step(pretrain=True)`)."""
    if streaming_steps > 0:
        return functools.partial(streaming_loss_fn, steps=streaming_steps)
    if pretrain:
        return functools.partial(loss_fn, qp_solve=False, lastqp_solve=False)
    return loss_fn


def train_step(policy, optimizer, batch: Dict[str, torch.Tensor],
               timings: Optional[Dict[str, float]] = None,
               loss: Callable = loss_fn, coeffs=None) -> Dict[str, torch.Tensor]:
    """One training step: forward and `loss` (with the rounds' `coeffs`),
    backward, clip, Adam, and for the delta variant the EMA of its scales.
    Returns the loss, loss_end, the gradient norm before clipping and, when
    the network runs a solver, the rounds' `deq_stats`, as device tensors.
    With `timings`, the device is synchronised after each part and its
    host-clock seconds are stored under forward_s, backward_s and
    optimizer_s."""
    sync = (torch.cuda.synchronize if timings is not None and batch["obs"].is_cuda
            else (lambda: None))
    t0 = time.perf_counter()
    optimizer.zero_grad(set_to_none=True)
    d = loss(policy, batch, coeffs=coeffs)
    sync()
    t1 = time.perf_counter()
    d["loss"].backward()
    sync()
    t2 = time.perf_counter()
    gnorm = clip_by_global_norm_(list(policy.model.parameters()))
    optimizer.step()
    if policy.is_delta and "opt_states" in d:
        with torch.no_grad():
            scales = policy.model.scales
            scales.copy_(update_scales(scales, list(d["opt_states"]), batch["state"],
                                       d["init_states"]))
    sync()
    if timings is not None:
        timings.update(forward_s=t1 - t0, backward_s=t2 - t1,
                       optimizer_s=time.perf_counter() - t2)
    out = {"loss": d["loss"].detach(), "loss_end": d["loss_end"].detach(), "grad_norm": gnorm}
    if "deq_stats" in d:
        out["deq_stats"] = d["deq_stats"]
    return out


def validate_policy(policy, val_samples: List[Dict[str, torch.Tensor]],
                    loss: Callable = loss_fn, coeffs=None) -> float:
    """Mean over the validation batches of loss_end (`train.py:404`)."""
    with torch.inference_mode():
        return float(np.mean([float(loss(policy, b, coeffs=coeffs)["loss_end"])
                              for b in val_samples]))


# -- CLI ------------------------------------------------------------------------

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
    p.add_argument("--teacher", type=str, default="mpc",
                   help="the expert data: data/expert_traj_<teacher>-<spec id>_new.pkl")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--solver_type", type=str, default="al", choices=["al", "ip"],
                   help="the tracking solve: augmented Lagrangian or interior-point SQP")
    p.add_argument("--qp_iter", type=int, default=1,
                   help="SQP iterations of the interior-point solve")
    p.add_argument("--eps", type=float, default=1e-2,
                   help="the interior-point solve's per-sample convergence threshold")
    p.add_argument("--ip_grad_method", type=str, default="analytic",
                   choices=["analytic", "autodiff", "finite_diff"],
                   help="the interior-point solve's dynamics linearisation")
    p.add_argument("--pretrain", action="store_true",
                   help=f"network-only steps (no solve) until step {PRETRAIN_STEPS}")
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--streaming_steps", type=int, default=3)
    p.add_argument("--streaming_start_iter", type=int, default=0)
    p.add_argument("--linearize_once", action="store_true")
    p.add_argument("--policy_variant", type=str, default="base", choices=POLICY_VARIANTS)
    p.add_argument("--addmem", action="store_true", help="the mem variant")
    p.add_argument("--layer_type", type=str, default="gcn", choices=["gcn", "mlp"])
    p.add_argument("--deq_out_type", type=int, default=1,
                   help="2: the history variant's joint state and action output (mlp)")
    p.add_argument("--H", type=int, default=1, help="the history variants' window")
    p.add_argument("--obstacle_net_input", action="store_true",
                   help="the network reads the nearest spheres of each knot")
    p.add_argument("--fp_type", type=str, default="anderson",
                   choices=["single", "multi", "broyden", "anderson"])
    p.add_argument("--inner_deq_iters", type=int, default=4,
                   help="cell applications a round under --fp_type multi")
    p.add_argument("--grad_type", type=str, default="fp_grad",
                   help="fp_grad (the phantom gradient), implicit, last_step_grad (with "
                        "--fp_type multi); any other value takes the default branch")
    p.add_argument("--m", type=int, default=5, help="Anderson's memory")
    p.add_argument("--max_steps", type=int, default=10, help="the fixed-point solver's steps")
    p.add_argument("--recompute_Qq", action="store_true",
                   help="refresh the tracking cost from the network between AL iterations")
    p.add_argument("--compute_dtype", choices=["f32", "bf16"], default="f32",
                   help="the trunk's matmul dtype (parameters, norms and solver stay f32)")
    p.add_argument("--grad_coeff", action="store_true",
                   help="per-round loss coefficients from the rounds' head-gradient ratios")
    p.add_argument("--Qscale", type=float, default=1.0,
                   help="the FlyingCartpole envs' velocity-weight scale")
    p.add_argument("--eval", action="store_true",
                   help="evaluate the loaded policy in closed loop instead of training")
    p.add_argument("--eval_episodes", type=int, default=32)
    p.add_argument("--eval_ep_len", type=int, default=None)
    p.add_argument("--eval_warm_start", choices=["auto", "on", "off"], default="auto",
                   help="warm-started ticks after tick 0; auto: iff --streaming")
    return p


def apply_model_type_presets(args):
    """What each model type sets (`train.py:167-188`): `deq` (false: the
    feed-forward `NNMPCPolicy`), the forward's `qp_solve` and
    `lastqp_solve`, and for the one-round types `deq_iter` = 1 and for the
    nn ones `deq_type`."""
    mt = args.model_type
    if mt == "deq-mpc-deq":
        args.deq, args.qp_solve, args.lastqp_solve = True, True, False
    elif mt == "deq-mpc-nn":
        args.deq, args.qp_solve, args.lastqp_solve = True, True, False
        args.deq_type = "nn"
    elif mt == "deq":
        args.deq, args.qp_solve, args.lastqp_solve = True, False, False
        args.deq_iter = 1
    elif mt == "nn":
        args.deq, args.qp_solve, args.lastqp_solve = False, False, False
        args.deq_iter = 1
    elif mt == "diff-mpc-deq":
        args.deq, args.qp_solve, args.lastqp_solve = True, False, True
        args.deq_iter = 1
    elif mt == "diff-mpc-nn":
        args.deq, args.qp_solve, args.lastqp_solve = True, False, True
        args.deq_iter = 1
        args.deq_type = "nn"
    return args


def parse_args(argv=None) -> argparse.Namespace:
    args, rest = build_argparser().parse_known_args(argv)
    if rest:
        raise NotImplementedError(f"flags not ported yet: {' '.join(rest)}")
    # the JAX CLI's defaults of the flags the port does not take, then the
    # model type's presets
    vars(args).update(
        deq_type="deq", dtype="float32", rho_max=None, kernel_width=3, deq_reg=0.1,
        loss_type="l1", policy_out_type=1, rho_init_max=1e4)
    return apply_model_type_presets(args)


def streaming_schedule(args: argparse.Namespace) -> int:
    """The warm rounds per streaming tick, `args.str_al_iter` (set here), as
    the JAX CLI computes it (`train.py:507-518`): the decades from the warm
    restart's rho to rho_max*100, two per round, at most deq_iter. Returns
    the rounds a step runs from the start, `total_deq_iter`, which names
    the run and scales its mean loss."""
    rho_max = args.rho_max or (1e8 if args.dtype == "double" else 1e5)
    rho_warm = min(args.rho_init_max, rho_max * 1e-4)
    args.str_al_iter = min(int(np.log10(rho_max * 100 / rho_warm) / 2), args.deq_iter)
    if args.streaming and args.streaming_start_iter == 0:
        return args.deq_iter + args.str_al_iter * args.streaming_steps
    return args.deq_iter


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    env = make_env_of(vars(args))
    if args.nq <= 0:
        args.nq = env.nq if env.nq <= env.nx // 2 else env.nx // 2
    total_deq_iter = streaming_schedule(args)
    policy = build_policy(vars(args), env, device, obstacles=build_obstacles(env)).init(args.seed)
    optimizer = make_optimizer(policy, args.lr)
    if args.load and args.ckpt:
        path = os.path.join(args.models_dir, args.ckpt)
        state, _ = load_checkpoint(path, device)
        policy.model.load_state_dict(state)
        opt_state = read_port_checkpoint(path)["optimizer"] if is_port_checkpoint(path) else None
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
    if args.eval:
        from .eval import eval_policy

        stats = eval_policy(vars(args), env, policy, n_episodes=args.eval_episodes,
                            ep_len=args.eval_ep_len, seed=args.seed, device=device,
                            warm_start={"auto": None, "on": True, "off": False}[args.eval_warm_start])
        print(json.dumps(stats), flush=True)
        return stats
    gt, val_gt = split_episodes(get_gt_data(env, args.teacher))
    rng = np.random.default_rng(args.seed)
    # windows of an H-step history (the policy sees the current state, or
    # the history variants the whole window); a streaming step reads T + L
    # states
    horizon = args.T + args.streaming_steps * int(args.streaming)
    val_samples = [to_device(preprocess_batch(args.env, env.nx,
                                              sample_trajectory(val_gt, args.bsz, args.H,
                                                                horizon, rng)),
                             device)
                   for _ in range(10)]
    name = args.name or (f"{args.model_type}_{args.env}_T{args.T}_bsz{args.bsz}"
                         f"_deq_iter{total_deq_iter}_hdim{args.hdim}")
    ckpt_path = os.path.join(args.models_dir, name)

    streaming_active = bool(args.streaming and args.streaming_start_iter == 0)
    pretrain_active = bool(args.pretrain and not streaming_active)
    loss = make_loss_fn(args.streaming_steps if streaming_active else 0, pretrain_active)
    coeffs = torch.ones((args.deq_iter, 3), dtype=torch.float32, device=device)
    best_val, curve = np.inf, []
    losses, losses_end = [], []
    t_window = time.perf_counter()
    for i in range(args.max_train_steps):
        if args.streaming and not streaming_active and i > args.streaming_start_iter:
            # the switch to the streaming step (`train.py:630-634`)
            streaming_active, pretrain_active = True, False
            loss = make_loss_fn(args.streaming_steps)
        elif pretrain_active and i >= PRETRAIN_STEPS:
            # the end of the network-only phase (`train.py:635-642`): the two
            # phases' validation losses do not compare
            pretrain_active, best_val = False, np.inf
            loss = make_loss_fn()
            print(f"[{i}] pretrain done: switching deq -> deqmpc", flush=True)
        batch = preprocess_batch(args.env, env.nx,
                                 sample_trajectory(gt, args.bsz, args.H, horizon, rng))
        batch = to_device(batch, device)
        out = train_step(policy, optimizer, batch, loss=loss, coeffs=coeffs)
        losses.append(out["loss"])
        losses_end.append(out["loss_end"])
        if i % args.val_every != 0:
            continue
        if not np.isfinite(float(out["loss"])):
            print(f"[{i}] non-finite loss, stopping", flush=True)
            break
        if args.grad_coeff and not streaming_active:
            try:
                ratios, _, _ = compute_grad_ratio_coeffs(policy, batch, qp_solve=args.qp_solve)
                coeffs = update_coeffs_ema(coeffs, ratios)
            except KeyError as e:
                print(f"[{i}] --grad_coeff disabled: no output head in the model ({e})",
                      flush=True)
                args.grad_coeff = False
        val = validate_policy(policy, val_samples, loss, coeffs)
        row = {"step": i,
               "loss_avg": float(torch.stack(losses).mean()) / total_deq_iter,
               "loss_end": float(torch.stack(losses_end).mean()),
               "val_loss_end": val, "grad_norm": float(out["grad_norm"]),
               "s_per_step": (time.perf_counter() - t_window) / len(losses),
               "streaming": streaming_active, "pretrain": pretrain_active}
        if "deq_stats" in out:
            row.update({f"deq_{k}": v.tolist() for k, v in out["deq_stats"].items()})
        if args.grad_coeff:
            row["coeffs"] = coeffs[:, 0].tolist()
        curve.append(row)
        print(json.dumps(row), flush=True)
        if args.save and val < best_val:
            best_val = val
            save_checkpoint(ckpt_path, policy.model, optimizer, i, vars(args))
        losses, losses_end = [], []
        t_window = time.perf_counter()
    result = {"env": args.env, "model_type": args.model_type, "solver_type": args.solver_type,
              "policy_variant": "mem" if args.addmem else args.policy_variant,
              "steps": args.max_train_steps, "bsz": args.bsz,
              "hdim": args.hdim, "deq_iter": args.deq_iter, "total_deq_iter": total_deq_iter,
              "streaming_steps": args.streaming_steps if args.streaming else 0,
              "device": str(device), "curve": curve,
              "checkpoint": ckpt_path if args.save else None}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
