"""The reference's side of `correct`: the frozen plain reference (`ref/`)
built from the checkpoint file and the data file alone, and the gaps
between its answers and the program's.

The reference never reads what the program made: it loads the weights with
its own reader, draws its own start states and batches from the seed, and
works out every Newton system again with the plain block-tridiagonal solve.
It runs with TF32 off (the configuration's f32); the control, the reference
in the next precision down, with TF32 on.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict

import numpy as np
import torch


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for matmuls and convolutions on or off inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def load(root, config: Dict, device):
    """(reference policy, env, args) from the configuration's checkpoint."""
    from portbench.ref.envs import make_env_of
    from portbench.ref.policies import build_policy
    from portbench.ref.utils.checkpoint import load_checkpoint

    state, args = load_checkpoint(str(root / config["checkpoint"]), device)
    env = make_env_of(args)
    policy = build_policy(args, env, device)
    policy.model.load_state_dict(state)
    return policy, env, args


class Reference:
    """The reference policy and env of one configuration, on `device`, with
    TF32 as `tf32` says."""

    def __init__(self, root, config: Dict, device, tf32: bool = False):
        self.device = torch.device(device)
        self.tf32 = tf32
        self.policy, self.env, self.args = load(root, config, self.device)

    def reset(self, seed: int, lanes: int) -> torch.Tensor:
        return self.env.reset(torch.Generator().manual_seed(seed), lanes, device="cpu")

    def forward(self, x: torch.Tensor):
        """(the network's first proposal, the first action of the last
        solve) for the states `x`, on the host: the whole batch in one
        forward, since the solver's exits and retries are batch-global."""
        with tf32(self.tf32), torch.inference_mode():
            trajs = self.policy.forward(x.to(self.device).float())["trajs"]
            return trajs[0][0].cpu(), trajs[-1][2][:, 0].cpu()

    def step_gap(self, x_in, u, x_out) -> float:
        """Largest gap of the program's env step to the reference's, over
        lanes and dims, relative to 1 + |reference|."""
        with torch.inference_mode():
            x_ref, _ = self.env.step(x_in.to(self.device), u.to(self.device))
            x_ref = x_ref.cpu()
        return float(gap(x_out.cpu(), x_ref).max())


def gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| / (1 + |b|) elementwise in f64; 0 where both are non-finite
    alike, infinite where only one is."""
    a, b = a.double(), b.double()
    d = (a - b).abs() / (1 + b.abs())
    both = ~torch.isfinite(a) & ~torch.isfinite(b)
    return torch.where(both, torch.zeros_like(d), torch.nan_to_num(d, nan=float("inf")))


def action_gaps(u_prog, u_ref) -> Dict[str, float]:
    """Each lane's largest gap over its action dims, for each compared tick
    (lists of (lanes, nu) tensors); over the lanes of all those ticks, the
    quantiles named and the largest; and the smallest of the ticks' own
    10th percentiles."""
    per_tick = [gap(p.cpu(), r.cpu()).amax(dim=-1).numpy() for p, r in zip(u_prog, u_ref)]
    per_lane = np.concatenate(per_tick)
    out = {f"action_gap_p{q}": float(np.quantile(per_lane, q / 100))
           for q in (1, 5, 10, 25, 75, 90)}
    out.update(action_gap_median=float(np.median(per_lane)), action_gap_max=float(per_lane.max()),
               action_gap_p10_tick_min=min(float(np.quantile(t, 0.1)) for t in per_tick))
    return out


@functools.lru_cache(maxsize=None)
def _counted(args_items) -> tuple:
    from portbench import flops
    from portbench.ref.envs import make_env_of
    from portbench.ref.policies import build_policy

    args = dict(args_items)
    env = make_env_of(args)
    policy = build_policy(args, env, "cpu")

    def dyn(b):
        x = env.reset(torch.Generator().manual_seed(0), b, device="cpu")
        env.dynamics(x, torch.zeros((b, env.nu)))

    def round_(b):
        x = env.reset(torch.Generator().manual_seed(0), b, device="cpu")
        with torch.no_grad():
            policy.model.step(x, policy._cold_aux(x))

    return flops.per_sample(dyn), flops.per_sample(round_)


def counted_work(config: Dict) -> tuple:
    """(operations of one dynamics step, of one policy round) per sample,
    counted on the reference on the host."""
    return _counted(tuple(sorted(config["args"].items())))

