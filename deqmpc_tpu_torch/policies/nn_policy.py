"""Plain behaviour-cloning policy: an MLP from the current state to a
T-step trajectory.

Port of `_Trunk` and `NNPolicy` (`deqmpc_tpu/policies/nn_policy.py:15-67`).
The trunk is Dense, LayerNorm, relu twice, then Dense, its submodules named
as flax names them (`Dense_0`, `LayerNorm_0`, ..., `Dense_2`), so a JAX
parameter tree maps onto `NNPolicy.net` through
`utils/checkpoint.params_from_jax`. `out_type` selects what the output
holds: 0 actions, 1 states, 2 states then actions, 3 configurations (the
velocities then come from finite differences over dt, the last repeated).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..models.blocks import LayerNorm


class _Trunk(nn.Module):
    def __init__(self, in_dim: int, hdim: int, out_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, hdim)
        self.LayerNorm_0 = LayerNorm(hdim)
        self.Dense_1 = nn.Linear(hdim, hdim)
        self.LayerNorm_1 = LayerNorm(hdim)
        self.Dense_2 = nn.Linear(hdim, out_dim)

    def forward(self, x):
        x = torch.relu(self.LayerNorm_0(self.Dense_0(x)))
        x = torch.relu(self.LayerNorm_1(self.Dense_1(x)))
        return self.Dense_2(x)


class NNPolicy:
    def __init__(self, nx: int, nu: int, nq: int, T: int, dt: float, hdim: int = 128,
                 out_type: int = 1, loss_type: str = "l1", device="cuda"):
        self.nx, self.nu, self.nq, self.T, self.dt = nx, nu, nq, T, dt
        self.out_type = out_type
        self.loss_type = loss_type
        self.deq_reg = 0.0
        out_dims = {0: nu * T, 1: nx * T, 2: (nx + nu) * T, 3: nq * T}
        if out_type not in out_dims:
            raise ValueError(out_type)
        self.net = _Trunk(nx, hdim, out_dims[out_type]).to(resolve_device(device))

    @torch.no_grad()
    def init(self, seed: int) -> "NNPolicy":
        """Seeded fresh parameters with flax's distributions (Dense kernels
        lecun-normal, biases and norm offsets zero, norm scales one), drawn
        on the CPU from one generator."""
        gen = torch.Generator().manual_seed(seed)
        for module in self.net.modules():
            if isinstance(module, nn.Linear):
                std = module.in_features ** -0.5 / 0.87962566103423978
                w = torch.empty(module.weight.shape, dtype=torch.float64)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
                module.weight.copy_(w)
                module.bias.zero_()
            elif isinstance(module, LayerNorm):
                module.scale.fill_(1.0)
                module.bias.zero_()
        return self

    def __call__(self, x) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(states, actions), either None as out_type says."""
        bsz = x.shape[0]
        out = self.net(x)
        T, nx, nu, nq = self.T, self.nx, self.nu, self.nq
        if self.out_type == 0:
            return None, out.reshape(bsz, T, nu)
        if self.out_type == 1:
            return out.reshape(bsz, T, nx), None
        if self.out_type == 2:
            return out[:, :nx * T].reshape(bsz, T, nx), out[:, nx * T:].reshape(bsz, T, nu)
        pos = out.reshape(bsz, T, nq)
        vel = (pos[:, 1:] - pos[:, :-1]) / self.dt
        vel = torch.cat([vel, vel[:, -1:]], dim=1)
        return torch.cat([pos, vel], dim=-1), None
