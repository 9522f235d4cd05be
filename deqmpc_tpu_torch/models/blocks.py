"""Building blocks of the DEQ trunks ("gcn" and "mlp").

Port of `UnfoldConv`, `get_act`, `MLPCell`, `ConvCell`, `MLPInput`,
`ConvInput` (with its extra streams), `MLPOutput`, `ConvOutput` and
`GatedResidual` (`deqmpc_tpu/models/blocks.py:22-227`). Layout is feature-last
(B, L, C) with convolutions over the horizon axis L, as in the JAX
package. Submodules and parameters carry the flax names (`Dense_0`,
`GroupNorm_1`, `kernel`, `scale`, ...) so the checkpoint maps onto
them one to one; `utils/checkpoint.py` transposes Dense kernels for
`nn.Linear`. Every flax `nn.Conv` of the JAX package (SAME padding,
`deq_layer_variants.py`) is an `UnfoldConv` here: the same kernel layout
and the same sum. The norms follow flax: eps 1e-6 and the one-pass variance
E[x^2] - E[x]^2 clipped at 0.

`dtype` (the trunk's `compute_dtype`, `blocks.py:22-58,71-203`): the
matmul dtype of the layers JAX gives it, `torch.bfloat16` for the tensor
cores. The stacked input (or the Dense input), the kernel and the bias are
cast to it and the bias is added in it, as flax does; parameters stay in
their own dtype. The norms then promote as flax's do: their statistics in
at least f32, the result in the dtype of the input promoted with the
parameters'. So the casts are written out; `torch.autocast` would keep
other ops in bf16 too.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def dense(layer: nn.Linear, x, dtype: Optional[torch.dtype] = None):
    """flax `nn.Dense(dtype=...)` on an `nn.Linear`: x, kernel and bias cast
    to `dtype` (None: the layer as it is), product, then the bias added."""
    if dtype is None:
        return layer(x)
    return x.to(dtype) @ layer.weight.to(dtype).T + layer.bias.to(dtype)


def _stats_input(x):
    """The input of a norm's statistics: at least f32, as flax's."""
    return x.float() if x.dtype in (torch.float16, torch.bfloat16) else x


class UnfoldConv(nn.Module):
    """Conv1d(k, SAME) as unfold plus ONE matmul: (B, L, k*Cin) @
    (k*Cin, Cout). The kernel keeps the flax layout (k, Cin, Cout)."""

    def __init__(self, cin: int, cout: int, kernel_width: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_width = kernel_width
        self.dtype = dtype
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
        kernel = self.kernel.reshape(-1, self.kernel.shape[-1])
        if self.dtype is None:
            return stacked @ kernel + self.bias
        return stacked.to(self.dtype) @ kernel.to(self.dtype) + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = _stats_input(x)
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
        x = _stats_input(x)
        B, L, C = x.shape
        G = self.num_groups
        xg = x.reshape(B, L, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
        y = (xg - mean).reshape(B, L, C)
        mul = torch.rsqrt(var + self.eps).expand(B, 1, G, C // G).reshape(B, 1, C)
        return y * (mul * self.scale) + self.bias


def get_act(name: str):
    """relu, or mish x * tanh(softplus(x)) (`blocks.py:61-68`); softplus as
    JAX's, logaddexp(x, 0), with no threshold."""
    if name == "relu":
        return torch.relu
    if name == "mish":
        return lambda x: x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))
    raise ValueError(name)


class MLPInput(nn.Module):
    """inp = LayerNorm(Dense(x_flat))."""

    def __init__(self, in_dim: int, hdim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, hdim)
        self.LayerNorm_0 = LayerNorm(hdim)

    def forward(self, x_flat):
        return self.LayerNorm_0(self.Dense_0(x_flat))


class MLPCell(nn.Module):
    """mlp DEQ cell on (B, hdim):
    z' = LN_1(relu(z + LN_2(x_inj + Dense_1(LN_0(relu(Dense_0(z))))))),
    flax naming the outer norm before the inner one."""

    def __init__(self, hdim: int, expand: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(hdim, hdim * expand)
        self.LayerNorm_0 = LayerNorm(hdim * expand)
        self.LayerNorm_1 = LayerNorm(hdim)
        self.LayerNorm_2 = LayerNorm(hdim)
        self.Dense_1 = nn.Linear(hdim * expand, hdim)

    def forward(self, x_inj, z):
        y = self.LayerNorm_0(torch.relu(dense(self.Dense_0, z, self.dtype)))
        return self.LayerNorm_1(torch.relu(
            z + self.LayerNorm_2(x_inj + dense(self.Dense_1, y, self.dtype))))


class MLPOutput(nn.Module):
    """out = Dense(z)."""

    def __init__(self, hdim: int, out_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(hdim, out_dim)

    def forward(self, z):
        return self.Dense_0(z)


class ConvInput(nn.Module):
    """gcn input encoder: per-knot embedding of the trajectory, the x0
    embedding broadcast over knots and a learned time embedding, then the
    `extra` streams (`extra_dim` channels in all: the memory, the nearest-
    obstacle features), fused by two convs and a GroupNorm."""

    def __init__(self, nx: int, obs_dim: int, hdim: int, horizon: int,
                 kernel_width: int = 3, num_groups: int = 4, extra_dim: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(nx, hdim)
        self.LayerNorm_0 = LayerNorm(hdim)
        self.Dense_1 = nn.Linear(obs_dim, hdim)
        self.LayerNorm_1 = LayerNorm(hdim)
        self.time_emb = nn.Parameter(torch.randn(horizon, hdim))
        self.Conv_0 = UnfoldConv(3 * hdim + extra_dim, 4 * hdim, kernel_width, dtype)
        self.Conv_1 = UnfoldConv(4 * hdim, hdim, kernel_width, dtype)
        self.GroupNorm_0 = GroupNorm(hdim, num_groups)

    def forward(self, x_nodes, obs, extra=()):
        # x_nodes: (B, T-1, nx); obs: (B, obs_dim); extra: (B, T-1, c) each
        node_emb = torch.relu(self.LayerNorm_0(dense(self.Dense_0, x_nodes, self.dtype)))
        x0_emb = torch.relu(self.LayerNorm_1(dense(self.Dense_1, obs, self.dtype)))
        x0_emb = x0_emb[:, None].expand(-1, x_nodes.shape[1], -1)
        t_emb = self.time_emb[None].expand_as(x0_emb)
        inp = torch.cat([node_emb, x0_emb, t_emb, *extra], dim=-1)
        inp = torch.relu(self.Conv_0(inp))
        return self.GroupNorm_0(self.Conv_1(inp))


class ConvCell(nn.Module):
    """gcn DEQ cell on (B, L, C):
    z' = GN_1(relu(z + GN_2(x_inj + Conv_1(GN_0(relu(Conv_0(z)))))))."""

    def __init__(self, hdim: int, expand: int = 4, kernel_width: int = 3,
                 num_groups: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Conv_0 = UnfoldConv(hdim, hdim * expand, kernel_width, dtype)
        self.Conv_1 = UnfoldConv(hdim * expand, hdim, kernel_width, dtype)
        self.GroupNorm_0 = GroupNorm(hdim * expand, num_groups)
        # flax names the outer norm before the inner one
        self.GroupNorm_1 = GroupNorm(hdim, num_groups)
        self.GroupNorm_2 = GroupNorm(hdim, num_groups)

    def forward(self, x_inj, z):
        y = self.GroupNorm_0(torch.relu(self.Conv_0(z)))
        return self.GroupNorm_1(torch.relu(z + self.GroupNorm_2(x_inj + self.Conv_1(y))))


class ConvOutput(nn.Module):
    """gcn output head: conv, GroupNorm, relu, then a width-1 conv, which
    keeps the parameters' dtype whatever `dtype` says (its output feeds the
    solver's reference)."""

    def __init__(self, out_dim: int, hdim: int, kernel_width: int = 3,
                 num_groups: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Conv_0 = UnfoldConv(hdim, hdim, kernel_width, dtype)
        self.GroupNorm_0 = GroupNorm(hdim, num_groups)
        self.Conv_1 = UnfoldConv(hdim, out_dim, kernel_width=1)

    def forward(self, z):
        return self.Conv_1(torch.relu(self.GroupNorm_0(self.Conv_0(z))))


class GatedResidual(nn.Module):
    """The memory update block. As in the JAX package (and the reference,
    which computes the gate and the residual and returns z), `bypass`
    returns z and holds no parameters; without it
    mem' = mem * (1 - gate) + res * gate over [mem, z], the gate
    sigmoid(LN_1(Dense_1(relu(LN_0(Dense_0(.)))))) and the residual the
    same with layers 2 and 3 (norms with eps 1e-3), named as flax names
    the layers of its two `Sequential`s."""

    def __init__(self, dim: int, bypass: bool = True):
        super().__init__()
        self.bypass = bypass
        if bypass:
            return
        for i in (0, 2):
            setattr(self, f"Dense_{i}", nn.Linear(2 * dim, 2 * dim))
            setattr(self, f"LayerNorm_{i}", LayerNorm(2 * dim, eps=1e-3))
            setattr(self, f"Dense_{i + 1}", nn.Linear(2 * dim, dim))
            setattr(self, f"LayerNorm_{i + 1}", LayerNorm(dim, eps=1e-3))

    def _branch(self, i, mz):
        h = torch.relu(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(mz)))
        return getattr(self, f"LayerNorm_{i + 1}")(getattr(self, f"Dense_{i + 1}")(h))

    def forward(self, mem, z):
        if self.bypass:
            return z
        mz = torch.cat([mem, z], dim=-1)
        gate = torch.sigmoid(self._branch(0, mz))
        return mem * (1 - gate) + self._branch(2, mz) * gate
