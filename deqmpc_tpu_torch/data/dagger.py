"""Corrective expert data from the states a policy visits (DAgger).

Port of `collect_policy_states`, `corrective_episodes` and `main`
(`deqmpc_tpu/data/dagger.py:34-216`). One round: roll the current policy
in closed loop, keep the states it visits (every `subsample`-th tick),
drop those outside the teacher's envelope, and restart the env's teacher
(`expert_gen`) from a sample of them; the corrective episodes are appended
to the dataset. The envelope is the committed dataset's 2nd to 98th
percentile per dim with a 1.5x margin (its first 200 episodes, every 8th
state); without a committed dataset, a ball of 4 |x_window| around the
target.

CLI (the train CLI's flags, which build the policy and load `--ckpt`
from `--models_dir`, and DAgger's own):
  python -m deqmpc_tpu_torch.data.dagger --env rexquadrotor --nq 6 --hdim 256 \
      --models_dir checkpoints --ckpt rexquad_deqmpc --dagger_episodes 256 [--cpu]

`--phase all` (the default) runs `collect` and then `shards` as
subprocesses of `python -m deqmpc_tpu_torch.data.dagger`; `collect` rolls
64 episodes of 200 ticks and saves the chosen starts to `--starts_npz`;
`shards` runs `python -m deqmpc_tpu_torch.data.expert_gen --append` once
per 64 starts. The episodes go to `--out` (default
`data_port/expert_traj_<teacher>-<spec id>_new.pkl`, which starts from the
committed dataset's episodes); the committed `data/` is never written.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

from ..envs import make_env
from ..policies.deqmpc_policy import f32_observation
from .datagen import PORT_DATA_DIR, expert_data_path, load_expert_pickle, port_data_path
from .expert_gen import (generate_flying_cartpole_expert, generate_mpc_expert,
                         generate_pendulum_energy_expert)

COLLECT_EPISODES, COLLECT_EP_LEN = 64, 200  # the collect phase's rollout (`dagger.py:164-165`)
SHARD = 64  # corrective starts per expert_gen subprocess


def teacher_envelope(env, teacher: str = "mpc"):
    """(center, half-width) of the committed dataset's 2nd-98th percentile
    box, or None when there is no such dataset."""
    path = expert_data_path(env.spec_id, teacher)
    if not path.exists():
        return None
    eps = load_expert_pickle(path)
    ds = np.stack([s for ep in eps[:200] for s, _ in ep[::8]])
    # percentiles, not min/max: the datasets carry a wild transient tail
    lo, hi = np.percentile(ds, 2, axis=0), np.percentile(ds, 98, axis=0)
    return (lo + hi) / 2, np.maximum((hi - lo) / 2, 1e-3)


def collect_policy_states(args, env, policy, n_episodes: int = COLLECT_EPISODES,
                          ep_len: int = COLLECT_EP_LEN, seed: int = 0,
                          subsample: int = 4) -> np.ndarray:
    """The policy's closed-loop states, every `subsample`-th tick from tick 0
    after the step, finite and inside the teacher's envelope: (n_states, nx).
    `args` gives `qp_solve`, `lastqp_solve` and `teacher`; the policy runs on
    its own device, from f32-rounded observations."""
    x = env.reset(torch.Generator().manual_seed(seed), n_episodes, device=policy.device,
                  dtype=torch.float64)
    mode = dict(qp_solve=args.qp_solve, lastqp_solve=args.lastqp_solve)
    visited = []
    with torch.inference_mode():
        for t in range(ep_len):
            u0 = policy.forward(f32_observation(policy, x), **mode)["trajs"][-1][2][:, 0]
            x, _ = env.step(x, u0)
            if t % subsample == 0:
                visited.append(x.cpu().numpy())
    out = np.concatenate(visited, axis=0)
    out = out[np.isfinite(out).all(axis=-1)]
    # states that escaped any recoverable envelope poison the dataset
    box = teacher_envelope(env, args.teacher)
    if box is not None:
        c, h = box
        return out[np.all(np.abs(out - c) <= 1.5 * h, axis=-1)]
    if not hasattr(env, "x_window"):
        return out
    d = np.linalg.norm(out - np.asarray(env.targ_pos), axis=-1)
    return out[d < 4.0 * float(np.linalg.norm(env.x_window))]


def corrective_episodes(args, env, starts: np.ndarray, ep_len: int, noise_std: float,
                        seed: int = 0, device="cuda"):
    """Expert demonstrations from the given starts, by the teacher
    `expert_gen` uses for `args.env`."""
    name = args.env
    if name.startswith("pendulum") and not name.endswith("stabilize"):
        return generate_pendulum_energy_expert(env, n_episodes=len(starts), ep_len=ep_len,
                                               seed=seed, noise_std=noise_std, x0=starts,
                                               device=device)
    if "FlyingCartpole" in name:
        return generate_flying_cartpole_expert(env, n_episodes=len(starts), ep_len=ep_len,
                                               seed=seed, x0=starts, device=device)
    return generate_mpc_expert(env, n_episodes=len(starts), ep_len=ep_len, seed=seed,
                               horizon=args.dagger_horizon, al_iters=args.al_iters,
                               noise_std=noise_std,
                               env_name=name, x0=starts, device=device)


def build_argparser():
    from ..training.train import build_argparser as train_argparser

    p = train_argparser()
    p.add_argument("--dagger_episodes", type=int, default=256,
                   help="number of corrective expert rollouts")
    p.add_argument("--dagger_ep_len", type=int, default=100,
                   help="length of each corrective expert rollout")
    p.add_argument("--dagger_horizon", type=int, default=30,
                   help="MPC-teacher horizon (cartpole/quadrotor)")
    p.add_argument("--al_iters", type=int, default=8)
    p.add_argument("--dagger_noise_std", type=float, default=0.1)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--phase", choices=["all", "collect", "shards"], default="all",
                   help="'all' runs collect and shards as subprocesses; "
                        "'collect'/'shards' are the worker phases")
    p.add_argument("--starts_npz", type=str, default=str(PORT_DATA_DIR / "dagger_starts.npz"))
    p.add_argument("--out", type=str, default=None,
                   help="the dataset to append to (default "
                        "data_port/expert_traj_<teacher>-<spec id>_new.pkl)")
    return p


def strip_phase(argv):
    """argv without its --phase flag, removed by position (a filter on the
    value would also drop an unrelated argument whose value is 'all')."""
    base = list(argv)
    for i, a in enumerate(base):
        if a == "--phase":
            del base[i:i + 2]
            break
        if a.startswith("--phase="):
            del base[i]
            break
    return base


def main(argv=None):
    from ..policies import build_policy
    from ..training.train import apply_model_type_presets
    from ..utils.checkpoint import load_checkpoint

    args = build_argparser().parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if args.phase == "all":
        base = strip_phase(argv if argv is not None else sys.argv[1:])
        for phase in ("collect", "shards"):
            rc = subprocess.run([sys.executable, "-m", "deqmpc_tpu_torch.data.dagger", *base,
                                 "--phase", phase]).returncode
            if rc != 0:
                raise SystemExit(f"dagger phase {phase} failed (rc={rc})")
        return None

    args = apply_model_type_presets(args)
    env = make_env(args.env)
    if args.nq <= 0:
        args.nq = env.nq if env.nq <= env.nx // 2 else env.nx // 2

    if args.phase == "collect":
        policy = build_policy(vars(args), env, args.device)
        state, _ = load_checkpoint(os.path.join(args.models_dir, args.ckpt), args.device)
        policy.model.load_state_dict(state)
        states = collect_policy_states(args, env, policy, seed=args.seed)
        if len(states) == 0:
            raise SystemExit(
                "dagger collect: the envelope filter rejected every visited state (the "
                "rollouts left the teacher's competence region entirely)")
        rng = np.random.default_rng(args.seed)
        idx = rng.choice(len(states), size=min(args.dagger_episodes, len(states)),
                         replace=False)
        os.makedirs(os.path.dirname(os.path.abspath(args.starts_npz)), exist_ok=True)
        np.savez(args.starts_npz, x0=states[idx])
        print(f"collected {len(idx)} start states -> {args.starts_npz}", flush=True)
        return states[idx]

    # shards: each SHARD starts in a fresh expert_gen process, appending
    starts = np.load(args.starts_npz)["x0"]
    path = args.out or str(port_data_path(env.spec_id, args.teacher))
    failed = 0
    for lo in range(0, len(starts), SHARD):
        shard_npz = f"{args.starts_npz}.shard{lo // SHARD}.npz"
        np.savez(shard_npz, x0=starts[lo:lo + SHARD])
        cmd = [sys.executable, "-m", "deqmpc_tpu_torch.data.expert_gen", "--env", args.env,
               "--x0_npz", shard_npz, "--append", "--teacher", args.teacher,
               "--ep_len", str(args.dagger_ep_len), "--horizon", str(args.dagger_horizon),
               "--al_iters", str(args.al_iters), "--noise_std", str(args.dagger_noise_std),
               "--seed", str(args.seed + lo), "--out", path]
        if args.cpu:
            cmd.append("--cpu")
        try:
            rc = subprocess.run(cmd).returncode
        finally:
            os.remove(shard_npz)
        print(f"shard {lo // SHARD}: rc={rc}", flush=True)
        failed += rc != 0
    n_eps = len(load_expert_pickle(path))
    print(f"dataset now has {n_eps} episodes -> {path}", flush=True)
    if failed:
        raise SystemExit(f"dagger shards: {failed} shard(s) failed; their corrective "
                         "episodes are missing")
    return path


if __name__ == "__main__":
    main()
