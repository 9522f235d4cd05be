"""Building blocks of the gcn DEQ trunk (`deqmpc_tpu/models/blocks.py`).

Layout is feature-last (B, L, C) with convolutions over the horizon axis L,
as in the JAX package. Submodules and parameters carry the flax names
(`Dense_0`, `GroupNorm_1`, `kernel`, `scale`, ...) so the checkpoint maps
onto them one to one; `utils/checkpoint.py` transposes Dense kernels for
`nn.Linear`. Every flax `nn.Conv` (SAME padding) is an `UnfoldConv` here:
the same kernel layout and the same sum. The norms follow flax: eps 1e-6
and the one-pass variance E[x^2] - E[x]^2 clipped at 0.
"""
from __future__ import annotations

import torch
from torch import nn


class UnfoldConv(nn.Module):
    """Conv1d(k, SAME) as unfold plus ONE matmul: (B, L, k*Cin) @
    (k*Cin, Cout). The kernel keeps the flax layout (k, Cin, Cout)."""

    def __init__(self, cin: int, cout: int, kernel_width: int = 3):
        super().__init__()
        self.kernel_width = kernel_width
        self.kernel = nn.Parameter(torch.empty(kernel_width, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.normal_(self.kernel, std=(kernel_width * cin) ** -0.5)

    def forward(self, x):
        k = self.kernel_width
        lo = (k - 1) // 2
        L = x.shape[-2]
        shifts = []
        for off in range(-lo, k - lo):
            if off < 0:
                s = nn.functional.pad(x[..., : L + off, :], (0, 0, -off, 0))
            elif off > 0:
                s = nn.functional.pad(x[..., off:, :], (0, 0, 0, off))
            else:
                s = x
            shifts.append(s)
        stacked = torch.cat(shifts, dim=-1)
        return stacked @ self.kernel.reshape(-1, self.kernel.shape[-1]) + self.bias


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm` on feature-last (B, L, C): statistics over L
    and the C/G channels of each group."""

    def __init__(self, features: int, num_groups: int = 4, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        B, L, C = x.shape
        G = self.num_groups
        xg = x.reshape(B, L, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
        y = (xg - mean).reshape(B, L, C)
        mul = torch.rsqrt(var + self.eps).expand(B, 1, G, C // G).reshape(B, 1, C)
        return y * (mul * self.scale) + self.bias


class ConvInput(nn.Module):
    """gcn input encoder: per-knot embedding of the trajectory, the x0
    embedding broadcast over knots and a learned time embedding, fused by
    two convs and a GroupNorm."""

    def __init__(self, nx: int, obs_dim: int, hdim: int, horizon: int,
                 kernel_width: int = 3, num_groups: int = 4):
        super().__init__()
        self.Dense_0 = nn.Linear(nx, hdim)
        self.LayerNorm_0 = LayerNorm(hdim)
        self.Dense_1 = nn.Linear(obs_dim, hdim)
        self.LayerNorm_1 = LayerNorm(hdim)
        self.time_emb = nn.Parameter(torch.randn(horizon, hdim))
        self.Conv_0 = UnfoldConv(3 * hdim, 4 * hdim, kernel_width)
        self.Conv_1 = UnfoldConv(4 * hdim, hdim, kernel_width)
        self.GroupNorm_0 = GroupNorm(hdim, num_groups)

    def forward(self, x_nodes, obs):
        # x_nodes: (B, T-1, nx); obs: (B, obs_dim)
        node_emb = torch.relu(self.LayerNorm_0(self.Dense_0(x_nodes)))
        x0_emb = torch.relu(self.LayerNorm_1(self.Dense_1(obs)))
        x0_emb = x0_emb[:, None].expand(-1, x_nodes.shape[1], -1)
        t_emb = self.time_emb[None].expand_as(x0_emb)
        inp = torch.cat([node_emb, x0_emb, t_emb], dim=-1)
        inp = torch.relu(self.Conv_0(inp))
        return self.GroupNorm_0(self.Conv_1(inp))


class ConvCell(nn.Module):
    """gcn DEQ cell on (B, L, C):
    z' = GN_1(relu(z + GN_2(x_inj + Conv_1(GN_0(relu(Conv_0(z)))))))."""

    def __init__(self, hdim: int, expand: int = 4, kernel_width: int = 3,
                 num_groups: int = 4):
        super().__init__()
        self.Conv_0 = UnfoldConv(hdim, hdim * expand, kernel_width)
        self.Conv_1 = UnfoldConv(hdim * expand, hdim, kernel_width)
        self.GroupNorm_0 = GroupNorm(hdim * expand, num_groups)
        # flax names the outer norm before the inner one
        self.GroupNorm_1 = GroupNorm(hdim, num_groups)
        self.GroupNorm_2 = GroupNorm(hdim, num_groups)

    def forward(self, x_inj, z):
        y = self.GroupNorm_0(torch.relu(self.Conv_0(z)))
        return self.GroupNorm_1(torch.relu(z + self.GroupNorm_2(x_inj + self.Conv_1(y))))


class ConvOutput(nn.Module):
    """gcn output head: conv, GroupNorm, relu, then a width-1 conv."""

    def __init__(self, out_dim: int, hdim: int, kernel_width: int = 3,
                 num_groups: int = 4):
        super().__init__()
        self.Conv_0 = UnfoldConv(hdim, hdim, kernel_width)
        self.GroupNorm_0 = GroupNorm(hdim, num_groups)
        self.Conv_1 = UnfoldConv(hdim, out_dim, kernel_width=1)

    def forward(self, z):
        return self.Conv_1(torch.relu(self.GroupNorm_0(self.Conv_0(z))))
