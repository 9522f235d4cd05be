"""Environment base: batched dynamics, Jacobians and the gym-style step.

Port of `deqmpc_tpu/envs/base.py`. A subclass defines `dynamics(x, u)`,
one discrete step that broadcasts over leading dims (JAX wrote it for
one sample and lifted it with `vmap`). Jacobians come from
`torch.func.vmap(torch.func.jacfwd(...))` and keep the contract
`(x_next, (Jx, Ju))` of `envs/base.py:60-82`; `finite_diff_derivatives`
is the central-difference oracle of the tests and `rollout` rolls a
control sequence out (`envs/base.py:84-104,135-146`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..utils import Spaces  # noqa: F401  (the envs' box spaces)


class Env:
    """Base class. Physical constants are numpy arrays; `_const` hands
    them out as tensors of the caller's dtype and device, made once."""

    nx: int
    nu: int
    nq: int
    dt: float
    spec_id: str = "Env-v0"  # names the env's expert data file
    _max_episode_steps: int = 200
    # the action that holds the target, in raw action coordinates: nonzero
    # only where the dynamics add no hover offset themselves (RexQuadrotor
    # takes raw rotor commands; FlyingCartpole adds u_hover inside)
    u_trim: float = 0.0

    def _const(self, name: str, like: torch.Tensor) -> torch.Tensor:
        cache = self.__dict__.setdefault("_const_cache", {})
        key = (name, like.dtype, like.device)
        if key not in cache:
            # a normal tensor even when first asked for in inference mode:
            # the Jacobians below use it outside inference mode
            with torch.inference_mode(False):
                cache[key] = torch.as_tensor(
                    np.asarray(getattr(self, name)), dtype=like.dtype,
                    device=like.device)
        return cache[key]

    # -- core dynamics -------------------------------------------------------
    def dynamics(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Discrete dynamics, broadcasting over any leading batch dims."""
        raise NotImplementedError

    def dynamics_derivatives(self, x: torch.Tensor, u: torch.Tensor
                             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Returns (x_next, (Jx, Ju)) with Jx: (..., nx, nx), Ju: (..., nx, nu),
        from one forward-mode Jacobian per sample."""
        nx, nu = self.nx, self.nu
        lead = x.shape[:-1]

        def f(xu_one):
            y = self.dynamics(xu_one[:nx], xu_one[nx:])
            return y, y

        # Forward-mode AD under vmap fails in inference mode on some PyTorch
        # releases ("Batching rule not implemented for aten::_make_dual"),
        # so the Jacobians run outside it, on a normal copy of the inputs.
        with torch.inference_mode(False), torch.no_grad():
            xu = torch.cat([x.reshape(-1, nx), u.reshape(-1, nu)], dim=-1)
            J, x_next = vmap(jacfwd(f, has_aux=True))(xu)
        Jx = J[..., :nx].reshape(*lead, nx, nx)
        Ju = J[..., nx:].reshape(*lead, nx, nu)
        return x_next.reshape(*lead, nx), (Jx, Ju)

    def finite_diff_derivatives(self, x: torch.Tensor, u: torch.Tensor, eps: float = 1e-6
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Central-difference Jacobians (Jx, Ju), one input dim at a time
        over the whole batch: (f(xu + eps e_i) - f(xu - eps e_i)) / (2 eps)."""
        nx, nu = self.nx, self.nu
        lead = x.shape[:-1]
        xf, uf = x.reshape(-1, nx), u.reshape(-1, nu)
        cols = []
        for i in range(nx + nu):
            d = torch.zeros(nx + nu, dtype=x.dtype, device=x.device)
            d[i] = eps
            xp = self.dynamics(xf + d[:nx], uf + d[nx:])
            xm = self.dynamics(xf - d[:nx], uf - d[nx:])
            cols.append((xp - xm) / (2 * eps))
        J = torch.stack(cols, dim=-1)
        return J[..., :nx].reshape(*lead, nx, nx), J[..., nx:].reshape(*lead, nx, nu)

    def rollout(self, x0: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        """The states (..., T+1, nx) from x0 (..., nx) under the controls
        us (..., T, nu), x0 first (no clipping, as JAX's `lax.scan`)."""
        xs = [x0]
        for t in range(us.shape[-2]):
            xs.append(self.dynamics(xs[-1], us[..., t, :]))
        return torch.stack(xs, dim=-2)

    # -- gym-style API (state passed explicitly) -----------------------------
    def reset(self, generator: torch.Generator, bsz: int, device="cuda",
              dtype=torch.float32) -> torch.Tensor:
        raise NotImplementedError

    def reward(self, x, u):
        raise NotImplementedError

    def action_clip(self, u):
        lo = torch.as_tensor(self.action_space.low, dtype=u.dtype, device=u.device)
        hi = torch.as_tensor(self.action_space.high, dtype=u.dtype, device=u.device)
        return torch.clamp(u, lo, hi)

    def state_clip(self, x):
        return x

    def is_bad_state(self, x, reward):
        """Per state, whether it or its reward is NaN or infinite."""
        return ~torch.isfinite(x).all(dim=-1) | ~torch.isfinite(reward)

    def step(self, x, u):
        """Functional step: (x, u) -> (x_next, reward)."""
        u = self.action_clip(u)
        x_next = self.state_clip(self.dynamics(x, u))
        return x_next, self.reward(x_next, u)

    @staticmethod
    def _uniform(generator: torch.Generator, bsz: int, lo, hi) -> torch.Tensor:
        """Uniform draws in [lo, hi), in f64 on the CPU: the same seed
        gives the same states whatever device the caller then uses."""
        lo = torch.as_tensor(np.asarray(lo, dtype=np.float64))
        hi = torch.as_tensor(np.asarray(hi, dtype=np.float64))
        r = torch.rand((bsz, lo.shape[-1]), generator=generator,
                       dtype=torch.float64)
        return lo + (hi - lo) * r
