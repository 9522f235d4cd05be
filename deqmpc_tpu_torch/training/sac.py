"""Soft actor-critic on the vectorised env: the RL teacher of the expert data.

Port of `obs_featurizer`, `TanhGaussianActor`, `DoubleCritic`, `squash`,
`unsquash_det`, the replay ring, `SACTrainer` and `main`
(`deqmpc_tpu/training/sac.py:36-413`): twin critics, a tanh-Gaussian
actor, an auto-tuned temperature. Each iteration steps every lane of a
`VecEnv` once, writes the transitions into the ring, and makes one update
on a sampled minibatch. JAX scans the loop inside one compiled call;
`run(state, n)` here is an eager loop of n iterations, and the MLPs are
plain `nn.Linear` layers (JAX computes them outside any Pallas kernel).

As in JAX:
- the layers start as flax's `Dense` does: the weight from a truncated
  normal of std 1/sqrt(fan_in) (lecun_normal), the bias zero, drawn from
  the trainer's generator;
- an update draws its Gaussian noise once and uses it both for the
  next-state action of the TD target and for the actor loss's action
  (JAX reuses one key for both draws);
- in order: the critic step, the actor loss against the updated critic,
  the temperature loss on the actor loss's (stopped) log-probability, and
  Polyak averaging of the target (a copy of the critic at the start)
  towards the updated critic;
- `_iter` steps the env twice: `VecEnv.step` gives the auto-reset state,
  `env.step` the true next state of the TD target; `bad` is taken on that
  state and the shaped reward; the batch is sampled after the write;
- on RexQuadrotor the critic loss goes infinite, as JAX's does; nothing
  here guards against it.

Random draws come from a `torch.Generator` in the state, where JAX splits
a key; `squash` takes its noise as a tensor, so a caller can give it any
draw. The replay holds f32 transitions, as JAX's.

CLI (JAX's flags; `--out` defaults to
`data_port/expert_traj_sac-<spec id>_new.pkl`; `--save_actor` pickles the
actor in flax's layout, {"params": {"Dense_i": {"kernel" (in, out),
"bias"}}} of numpy arrays, which either package reads):
  python -m deqmpc_tpu_torch.training.sac --env pendulum --total_steps 150000 \
      --episodes 256 [--cpu] [--save_actor actor.pkl]
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import io
import math
import pickle
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..envs.vec_env import VecEnv, VecEnvState
from ..utils import angle_idxs_for_env

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0
# flax's lecun_normal: a normal truncated at +-2, scaled to variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def obs_featurizer(env_name: str, nx: int) -> Tuple[Callable, int]:
    """The RL observation map and its width: each angle dim lifted to
    (cos, sin), the rest kept (`sac.py:36-56`)."""
    idxs = angle_idxs_for_env(env_name, nx)
    if idxs is None or len(idxs) == 0:
        return (lambda x: x), nx
    mask = np.zeros(nx, bool)
    mask[np.asarray(idxs)] = True
    idx, rest = list(np.asarray(idxs)), list(np.nonzero(~mask)[0])

    def feat(x):
        th = x[..., idx]
        return torch.cat([torch.cos(th), torch.sin(th), x[..., rest]], dim=-1)

    return feat, 2 * len(idx) + len(rest)


def dense_init_(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax `Dense`'s initialisation: lecun_normal weight, zero bias."""
    std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        layer.bias.zero_()


class TanhGaussianActor(nn.Module):
    """`layers` 0-1 the trunk, 2 the mean, 3 the log-std (flax's Dense_0..3)."""

    def __init__(self, nobs: int, nu: int, hdim: int = 256):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(nobs, hdim), nn.Linear(hdim, hdim),
                                     nn.Linear(hdim, nu), nn.Linear(hdim, nu)])

    def forward(self, obs):
        h = torch.relu(self.layers[0](obs))
        h = torch.relu(self.layers[1](h))
        log_std = torch.clamp(self.layers[3](h), LOG_STD_MIN, LOG_STD_MAX)
        return self.layers[2](h), log_std


class DoubleCritic(nn.Module):
    """`layers` 0-2 the first Q head, 3-5 the second (flax's Dense_0..5:
    JAX's compact module calls its `q` twice)."""

    def __init__(self, nobs: int, nu: int, hdim: int = 256):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(nobs + nu, hdim), nn.Linear(hdim, hdim),
                                     nn.Linear(hdim, 1), nn.Linear(nobs + nu, hdim),
                                     nn.Linear(hdim, hdim), nn.Linear(hdim, 1)])

    def _q(self, x, k):
        h = torch.relu(self.layers[k](x))
        h = torch.relu(self.layers[k + 1](h))
        return self.layers[k + 2](h)[..., 0]

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self._q(x, 0), self._q(x, 3)


def init_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    for layer in module.layers:
        dense_init_(layer, generator)
    return module


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus, no threshold


def squash(mu, log_std, eps, u_lo, u_hi):
    """A tanh-squashed Gaussian action pre = mu + exp(log_std) eps scaled to
    the box, and its log-probability summed over the action dims."""
    pre = mu + torch.exp(log_std) * eps
    a = torch.tanh(pre)
    # log N(pre) - log |d tanh|, in the stable softplus form
    logp = (-0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
            - 2 * (math.log(2.0) - pre - _softplus(-2 * pre)))
    scale = (u_hi - u_lo) / 2.0
    act = u_lo + (a + 1.0) * scale
    return act, torch.sum(logp - torch.log(scale), dim=-1)


def unsquash_det(mu, u_lo, u_hi):
    return u_lo + (torch.tanh(mu) + 1.0) * (u_hi - u_lo) / 2.0


@dataclasses.dataclass
class Replay:
    obs: torch.Tensor
    act: torch.Tensor
    rew: torch.Tensor
    nobs: torch.Tensor
    done: torch.Tensor
    ptr: int = 0   # write cursor
    size: int = 0  # fill level


@dataclasses.dataclass
class SACState:
    actor: TanhGaussianActor
    critic: DoubleCritic
    target: DoubleCritic
    log_alpha: torch.Tensor
    opt_actor: torch.optim.Optimizer
    opt_critic: torch.optim.Optimizer
    opt_alpha: torch.optim.Optimizer
    env_state: VecEnvState
    replay: Replay
    generator: torch.Generator
    step: int = 0


class SACTrainer:
    """The collect-and-update loop (`sac.py:117-369`). `dtype` is that of
    the networks and the env lanes (f32 as JAX's default)."""

    def __init__(self, env, env_name: str, n_envs: int = 128, hdim: int = 256,
                 buffer_size: int = 200_000, batch: int = 256, gamma: float = 0.99,
                 tau: float = 0.005, lr: float = 3e-4, start_steps: int = 2_000,
                 ep_len: int = 200, smooth_w: float = 0.0, device="cuda",
                 dtype=torch.float32):
        self.env = env
        # a quadratic penalty on joint velocities and the normalised action:
        # without it SAC learns chattering bang-bang limit cycles
        self.smooth_w = float(smooth_w)
        self.n_envs = n_envs
        self.device = resolve_device(device)
        self.dtype = dtype
        self.vec = VecEnv(env, n_envs=n_envs, max_episode_steps=ep_len, device=self.device,
                          dtype=dtype)
        self.feat, self.nobs_dim = obs_featurizer(env_name, env.nx)
        self.nu = env.nu
        # the box in f32 whatever `dtype`, as JAX keeps it: squash's log of
        # its half-width is an f32 value
        self.u_lo = torch.as_tensor(env.action_space.low, dtype=torch.float32,
                                    device=self.device)
        self.u_hi = torch.as_tensor(env.action_space.high, dtype=torch.float32,
                                    device=self.device)
        self.hdim = hdim
        self.gamma, self.tau, self.lr = gamma, tau, lr
        self.batch = batch
        self.buffer_size = buffer_size
        self.start_steps = start_steps
        self.target_entropy = -float(env.nu)

    def _adam(self, params):
        return torch.optim.Adam(params, lr=self.lr)

    def init(self, seed: int = 0) -> SACState:
        gen = torch.Generator().manual_seed(seed)
        actor = init_module_(TanhGaussianActor(self.nobs_dim, self.nu, self.hdim).to(self.dtype),
                             gen).to(self.device)
        critic = init_module_(DoubleCritic(self.nobs_dim, self.nu, self.hdim).to(self.dtype),
                              gen).to(self.device)
        return self.state_from(actor, critic, gen)

    def state_from(self, actor, critic, generator: torch.Generator,
                   log_alpha: float = 0.0) -> SACState:
        """A fresh state around given networks: the target a copy of the
        critic, new optimizers, an empty replay, the env reset from `generator`."""
        log_alpha = torch.tensor(log_alpha, dtype=self.dtype, device=self.device,
                                 requires_grad=True)
        B, f32 = self.buffer_size, dict(dtype=torch.float32, device=self.device)
        replay = Replay(obs=torch.zeros((B, self.env.nx), **f32),
                        act=torch.zeros((B, self.nu), **f32), rew=torch.zeros((B,), **f32),
                        nobs=torch.zeros((B, self.env.nx), **f32), done=torch.zeros((B,), **f32))
        target = copy.deepcopy(critic).requires_grad_(False)
        return SACState(actor=actor, critic=critic, target=target, log_alpha=log_alpha,
                        opt_actor=self._adam(actor.parameters()),
                        opt_critic=self._adam(critic.parameters()),
                        opt_alpha=self._adam([log_alpha]),
                        env_state=self.vec.reset(generator), replay=replay,
                        generator=generator)

    def _randn(self, state: SACState, shape):
        return torch.randn(shape, generator=state.generator, dtype=self.dtype).to(self.device)

    # -- one collect+update iteration ---------------------------------------
    def _iter(self, state: SACState) -> Tuple[SACState, Dict[str, torch.Tensor]]:
        x = state.env_state.x
        eps_act = self._randn(state, (self.n_envs, self.nu))
        r = torch.rand((self.n_envs, self.nu), generator=state.generator,
                       dtype=self.dtype).to(self.device)
        if state.step < self.start_steps:  # uniform actions until the buffer warms up
            a = self.u_lo + (self.u_hi - self.u_lo) * r
        else:
            with torch.no_grad():
                mu, log_std = state.actor(self.feat(x))
                a, _ = squash(mu, log_std, eps_act, self.u_lo, self.u_hi)
        state.env_state, _, rew, _ = self.vec.step(state.env_state, a)
        if self.smooth_w > 0:
            nq = self.env.nx // 2
            u_n = (2 * a - (self.u_hi + self.u_lo)) / (self.u_hi - self.u_lo)
            rew = rew - self.smooth_w * (torch.sum(x[..., nq:] ** 2, dim=-1)
                                         + torch.sum(u_n ** 2, dim=-1))
        # the true next state (before the reset) for the TD target: an episode
        # ended by its time limit bootstraps (done 0), a bad state does not
        x_next_true = self.env.step(x, a)[0]
        bad = self.env.is_bad_state(x_next_true, rew)
        self._write(state.replay, x, a, rew, x_next_true, bad.to(torch.float32))
        batch = self._sample(state.replay, state.generator)
        eps = self._randn(state, (self.batch, self.nu))
        state.step += 1
        state, info = self._update(state, batch, eps)
        info["rew"] = rew.mean()
        return state, info

    def _write(self, rp: Replay, obs, act, rew, nobs, done) -> Replay:
        """Write a lane batch at the cursor, wrapping around the ring."""
        idx = (rp.ptr + torch.arange(self.n_envs, device=rp.obs.device)) % self.buffer_size
        for buf, v in ((rp.obs, obs), (rp.act, act), (rp.rew, rew), (rp.nobs, nobs),
                       (rp.done, done)):
            buf[idx] = v.to(buf.dtype)
        rp.ptr = (rp.ptr + self.n_envs) % self.buffer_size
        rp.size = min(rp.size + self.n_envs, self.buffer_size)
        return rp

    def _sample(self, rp: Replay, generator: torch.Generator):
        idx = torch.randint(0, rp.size, (self.batch,), generator=generator).to(rp.obs.device)
        return tuple(buf[idx] for buf in (rp.obs, rp.act, rp.rew, rp.nobs, rp.done))

    def _update(self, state: SACState, batch, eps) -> Tuple[SACState, Dict[str, torch.Tensor]]:
        """One update on `batch` (obs, act, rew, nobs, done) with the
        Gaussian noise `eps` (batch, nu) of both of its action draws."""
        obs, act, rew, nobs, done = (t.to(self.dtype) for t in batch)
        obs_f, nobs_f = self.feat(obs), self.feat(nobs)
        alpha = torch.exp(state.log_alpha.detach())
        with torch.no_grad():
            mu_n, ls_n = state.actor(nobs_f)
            a_n, logp_n = squash(mu_n, ls_n, eps, self.u_lo, self.u_hi)
            q1_t, q2_t = state.target(nobs_f, a_n)
            target = rew + self.gamma * (1 - done) * (torch.minimum(q1_t, q2_t) - alpha * logp_n)

        q1, q2 = state.critic(obs_f, act)
        cl = torch.mean((q1 - target) ** 2 + (q2 - target) ** 2)
        state.opt_critic.zero_grad(set_to_none=True)
        cl.backward()
        state.opt_critic.step()

        state.critic.requires_grad_(False)  # the actor loss reads the updated critic
        try:
            mu, ls = state.actor(obs_f)
            a, logp = squash(mu, ls, eps, self.u_lo, self.u_hi)
            q1, q2 = state.critic(obs_f, a)
            al = torch.mean(alpha * logp - torch.minimum(q1, q2))
            state.opt_actor.zero_grad(set_to_none=True)
            al.backward()
            state.opt_actor.step()
        finally:
            state.critic.requires_grad_(True)

        tl = -torch.mean(state.log_alpha * (logp.detach() + self.target_entropy))
        state.opt_alpha.zero_grad(set_to_none=True)
        tl.backward()
        state.opt_alpha.step()

        with torch.no_grad():
            for t, o in zip(state.target.parameters(), state.critic.parameters()):
                t.copy_((1 - self.tau) * t + self.tau * o)
        return state, {"critic_loss": cl.detach(), "actor_loss": al.detach(), "alpha": alpha}

    def run(self, state: SACState, n: int) -> Tuple[SACState, Dict[str, torch.Tensor]]:
        """n iterations; the info of each, stacked."""
        infos = []
        for _ in range(n):
            state, info = self._iter(state)
            infos.append(info)
        return state, {k: torch.stack([i[k] for i in infos]) for k in infos[0]}

    # -- expert dataset --------------------------------------------------------
    def generate_expert(self, state: SACState, n_episodes: int = 256, ep_len: int = 200,
                        seed: int = 1, noise_std: float = 0.0) -> List:
        """Deterministic (tanh-mean) rollouts from seeded starts in the expert
        pickle format; with `noise_std` the env steps with a perturbed action
        and the clean one is recorded. Non-finite episodes are dropped."""
        gen = torch.Generator().manual_seed(seed)
        x = self.env.reset(gen, n_episodes, device=self.device, dtype=self.dtype)
        noise = torch.randn((ep_len, n_episodes, self.nu), generator=gen,
                            dtype=self.dtype).to(self.device)
        xs, us = [], []
        with torch.no_grad():
            for t in range(ep_len):
                mu, _ = state.actor(self.feat(x))
                u = unsquash_det(mu, self.u_lo, self.u_hi)
                u_apply = u
                if noise_std > 0:
                    u_apply = torch.clamp(u + noise_std * noise[t], self.u_lo.to(u.dtype),
                                          self.u_hi.to(u.dtype))
                xs.append(self.env.state_clip(x).cpu())
                us.append(u.cpu())
                x = self.env.step(x, u_apply)[0]
        states = torch.stack(xs, dim=1).numpy()
        actions = torch.stack(us, dim=1).numpy()
        ok = np.isfinite(states).all(axis=(1, 2)) & np.isfinite(actions).all(axis=(1, 2))
        return [[(states[b, t], actions[b, t]) for t in range(ep_len)]
                for b in np.nonzero(ok)[0]]


# -- the actor in flax's layout --------------------------------------------------

def save_actor(path, actor: TanhGaussianActor) -> None:
    """Pickle the actor as flax's parameter tree of numpy arrays."""
    from ..utils.checkpoint import dense_stack_to_jax

    with open(path, "wb") as f:
        pickle.dump(dense_stack_to_jax(actor.state_dict()), f)


def load_actor(path, device="cuda", dtype=torch.float32) -> TanhGaussianActor:
    """An actor from a pickled flax tree (either package's `--save_actor`)."""
    from ..data.datagen import _ExpertUnpickler
    from ..utils.checkpoint import dense_stack_from_jax

    with open(path, "rb") as f:
        tree = _ExpertUnpickler(io.BytesIO(f.read())).load()
    state = dense_stack_from_jax(tree)
    w0, w2 = state["layers.0.weight"], state["layers.2.weight"]
    actor = TanhGaussianActor(w0.shape[1], w2.shape[0], w0.shape[0])
    actor.load_state_dict(state)
    return actor.to(device=resolve_device(device), dtype=dtype)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env", type=str, default="pendulum")
    p.add_argument("--n_envs", type=int, default=128)
    p.add_argument("--total_steps", type=int, default=150_000,
                   help="collect+update iterations (each steps all lanes)")
    p.add_argument("--hdim", type=int, default=256)
    p.add_argument("--ep_len", type=int, default=200)
    p.add_argument("--episodes", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise_std", type=float, default=0.2,
                   help="DART exploration noise during expert rollouts (clean actions recorded)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--smooth_w", type=float, default=0.0,
                   help="quadratic velocity+action reward shaping")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--save_actor", type=str, default=None,
                   help="pickle the trained actor (flax's layout) here")
    args = p.parse_args(argv)

    from ..data.datagen import port_data_path, write_episodes
    from ..envs import make_env

    env = make_env(args.env)
    tr = SACTrainer(env, args.env, n_envs=args.n_envs, hdim=args.hdim, ep_len=args.ep_len,
                    smooth_w=args.smooth_w, device="cpu" if args.cpu else "cuda")
    state = tr.init(args.seed)
    chunk = 1000
    for i in range(0, args.total_steps, chunk):
        state, info = tr.run(state, chunk)
        print(f"iter {i + chunk}: rew={float(info['rew'].mean()):.4f} "
              f"critic={float(info['critic_loss'].mean()):.4f} "
              f"alpha={float(info['alpha'][-1]):.4f}", flush=True)
    if args.save_actor:
        save_actor(args.save_actor, state.actor)
    episodes = tr.generate_expert(state, n_episodes=args.episodes, ep_len=args.ep_len,
                                  seed=args.seed + 1, noise_std=args.noise_std)
    path = args.out or port_data_path(env.spec_id, "sac")
    write_episodes(path, episodes)
    # the wrap-aware final distance
    d = np.asarray([ep[-1][0] for ep in episodes]) - np.asarray(env.targ_pos)
    idxs = angle_idxs_for_env(args.env, env.nx)
    for i_ in ([] if idxs is None else idxs):
        d[:, i_] = np.angle(np.exp(1j * d[:, i_]))
    dist = np.linalg.norm(d, axis=-1)
    print(f"saved {len(episodes)} episodes to {path}; "
          f"final dist mean={dist.mean():.3f} median={np.median(dist):.3f}", flush=True)
    return path, episodes


if __name__ == "__main__":
    main()
