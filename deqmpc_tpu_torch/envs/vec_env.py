"""Vectorised environment with auto-reset.

Port of `VecEnvState` and `VecEnv` (`deqmpc_tpu/envs/vec_env.py:22-58`):
a batched rollout interface with per-lane step counters that resets a
lane when its episode reaches the step limit or its state goes bad (NaN,
infinite, or the env's own test), and zeroes the reward of a bad lane.
JAX carries a PRNG key in the state and splits it every step; here the
state carries a `torch.Generator`, and every step draws a whole batch of
reset states from it, whether or not a lane is done, as JAX draws
`x_reset` every step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import resolve_device


class VecEnvState(NamedTuple):
    x: torch.Tensor          # (n_envs, nx)
    num_steps: torch.Tensor  # (n_envs,) int32
    generator: torch.Generator


class VecEnv:
    def __init__(self, env, n_envs: int = 4096, max_episode_steps: Optional[int] = None,
                 device="cuda", dtype=torch.float32):
        self.env = env
        self.n_envs = n_envs
        self.max_steps = max_episode_steps or env._max_episode_steps
        self.device = resolve_device(device)
        self.dtype = dtype

    def _reset_states(self, generator: torch.Generator) -> torch.Tensor:
        return self.env.reset(generator, self.n_envs, device=self.device, dtype=self.dtype)

    def reset(self, generator: torch.Generator) -> VecEnvState:
        return VecEnvState(
            x=self._reset_states(generator),
            num_steps=torch.zeros((self.n_envs,), dtype=torch.int32, device=self.device),
            generator=generator)

    def step(self, state: VecEnvState, u: torch.Tensor
             ) -> Tuple[VecEnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (new_state, obs, reward, done); done lanes start again
        from a fresh reset state."""
        x_next, reward = self.env.step(state.x, u)
        bad = self.env.is_bad_state(x_next, reward)
        num_steps = state.num_steps + 1
        done = (num_steps >= self.max_steps) | bad
        reward = torch.where(bad, torch.zeros_like(reward), reward)
        x_reset = self._reset_states(state.generator)
        x_new = torch.where(done[:, None], x_reset, x_next)
        num_steps = torch.where(done, torch.zeros_like(num_steps), num_steps)
        return VecEnvState(x=x_new, num_steps=num_steps, generator=state.generator), \
            x_new, reward, done
