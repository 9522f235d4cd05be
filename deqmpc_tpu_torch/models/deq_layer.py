"""DEQ layer: the fixed-point trajectory-proposal network (gcn trunk).

Port of `DEQLayerConfig`, `DEQLayer` and `FFDNetwork`
(`deqmpc_tpu/models/deq_layer.py:80-311`): the input encoder embeds the
observation and the carried trajectory, `_fixed_point` runs Anderson on
the cell and then applies the cell three more times (or, with
`fp_type="single"`, the feed-forward `FFDNetwork` of deq-mpc-nn, applies
it once to the carried z, with its gradient), and `_decode` turns the
(T-1) x nx head output into the reference trajectory.

Gradient ("phantom gradient", `deq_layer.py:254-272`): Anderson runs
under `torch.no_grad()` from a detached z, its result is detached, and
only the three re-applications of the cell carry a gradient. It is not
implicit differentiation, and no gradient reaches the incoming z.

Decode convention (`deq_layer.py:274-285`): positions integrate from the
current state (x_ref_pos = x0_pos + dq*dt), velocities are direct
predictions, and the observation is prepended as knot 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from ..solvers.fp import anderson
from .blocks import ConvCell, ConvInput, ConvOutput, GroupNorm, LayerNorm, UnfoldConv


@dataclasses.dataclass(frozen=True)
class DEQLayerConfig:
    nx: int
    nu: int
    nq: int
    T: int
    dt: float
    hdim: int = 128
    deq_iter: int = 6
    fp_m: int = 5
    fp_max_steps: int = 10
    kernel_width: int = 3
    deq_expand: int = 4
    num_groups: int = 4
    fp_type: str = "anderson"  # or "single": one cell application


class DEQLayer(nn.Module):
    """Base DEQ layer with the gcn trunk and Anderson: state-prediction
    output (deq_out_type=1)."""

    def __init__(self, cfg: DEQLayerConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.input = ConvInput(nx=c.nx, obs_dim=c.nx, hdim=c.hdim, horizon=c.T - 1,
                               kernel_width=c.kernel_width, num_groups=c.num_groups)
        self.cell = ConvCell(hdim=c.hdim, expand=c.deq_expand,
                             kernel_width=c.kernel_width, num_groups=c.num_groups)
        self.out = ConvOutput(out_dim=c.nx, hdim=c.hdim, kernel_width=c.kernel_width,
                              num_groups=c.num_groups)
        # per-iteration embedding: in the checkpoint, unused by the base
        # forward exactly as in the JAX package (`deq_layer.py:154-163`)
        self.iter_emb = nn.Parameter(torch.zeros(c.deq_iter, c.T - 1, c.hdim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Seeded initialisation for a fresh run. Every draw is made on the
        CPU from `generator`, so one seed gives the same weights on any
        device. The distributions are flax's (`models/blocks.py` of the
        JAX package): Dense and conv kernels lecun-normal (a normal
        truncated at two standard deviations, variance 1/fan_in), the time
        embedding N(0, 1), biases, norm offsets and `iter_emb` zero, norm
        scales one. The draws are not flax's: a port run and a JAX run
        from the same seed start from different weights."""

        def lecun_normal(p, fan_in):
            std = fan_in ** -0.5 / 0.87962566103423978
            w = torch.empty(p.shape, dtype=torch.float64)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            p.copy_(w)

        for module in self.modules():
            if isinstance(module, nn.Linear):
                lecun_normal(module.weight, module.in_features)
                module.bias.zero_()
            elif isinstance(module, UnfoldConv):
                k, cin, _ = module.kernel.shape
                lecun_normal(module.kernel, k * cin)
                module.bias.zero_()
            elif isinstance(module, (LayerNorm, GroupNorm)):
                module.scale.fill_(1.0)
                module.bias.zero_()
        t_emb = self.input.time_emb
        t_emb.copy_(torch.randn(t_emb.shape, generator=generator, dtype=torch.float64))
        self.iter_emb.zero_()

    def init_z(self, bsz: int, dtype=None, device=None):
        c = self.cfg
        return torch.zeros((bsz, c.T - 1, c.hdim), dtype=dtype or self.iter_emb.dtype,
                           device=device or self.iter_emb.device)

    def _fixed_point(self, inj, z):
        """Anderson on the cell without a gradient, then three cell
        applications with one (the phantom gradient); with fp_type
        "single", one cell application with its gradient."""
        c = self.cfg

        def f(zz):
            return self.cell(inj, zz)

        if c.fp_type == "single":
            return f(z)

        with torch.no_grad():
            z_star, _ = anderson(f, z.detach(), m=c.fp_m, max_steps=c.fp_max_steps)
        return f(f(f(z_star.detach())))

    def _decode(self, obs, x_prev, dx_ref):
        """(T-1) x nx deltas -> x_ref (bsz, T, nx) with obs prepended."""
        c = self.cfg
        bsz = obs.shape[0]
        dx_ref = dx_ref.reshape(bsz, c.T - 1, c.nx)
        pos = dx_ref[..., : c.nq] * c.dt + x_prev[..., :1, : c.nq]
        x_tail = torch.cat([pos, dx_ref[..., c.nq:]], dim=-1)
        x_ref = torch.cat([obs[:, None, :], x_tail], dim=-2)
        u_ref = torch.zeros((bsz, c.T, c.nu), dtype=x_ref.dtype, device=x_ref.device)
        return x_ref, u_ref

    def forward(self, obs, x_prev, z) -> Tuple[Dict, torch.Tensor]:
        """obs (bsz, nx), x_prev (bsz, T, nx), z (bsz, T-1, hdim) ->
        ({"x_t", "x_ref", "u_ref"}, z_out)."""
        z_out = self._fixed_point(self.input(x_prev[:, 1:], obs), z)
        x_ref, u_ref = self._decode(obs, x_prev, self.out(z_out))
        return {"x_t": obs, "x_ref": x_ref, "u_ref": u_ref}, z_out


class FFDNetwork(DEQLayer):
    """The feed-forward proposal network of deq_type "nn"
    (`deq_layer.py:305-311`): the same trunk, one un-accelerated cell
    application per round."""

    def __init__(self, cfg: DEQLayerConfig):
        super().__init__(dataclasses.replace(cfg, fp_type="single"))
