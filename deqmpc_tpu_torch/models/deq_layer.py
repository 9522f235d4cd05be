"""DEQ layer: the fixed-point trajectory-proposal network (gcn trunk).

Port of `DEQLayerConfig` and `DEQLayer` (`deqmpc_tpu/models/deq_layer.py:80-302`)
for serving: the input encoder embeds the observation and the carried
trajectory, `_fixed_point` runs Anderson on the cell and then applies
the cell three more times (the phantom-gradient re-applications of the
JAX training path, plain applications here), and `_decode` turns the
(T-1) x nx head output into the reference trajectory.

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
from .blocks import ConvCell, ConvInput, ConvOutput


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

    def init_z(self, bsz: int, dtype=None, device=None):
        c = self.cfg
        return torch.zeros((bsz, c.T - 1, c.hdim), dtype=dtype or self.iter_emb.dtype,
                           device=device or self.iter_emb.device)

    def _fixed_point(self, inj, z):
        """Anderson on the cell, then three plain cell applications."""
        c = self.cfg

        def f(zz):
            return self.cell(inj, zz)

        z_star, _ = anderson(f, z, m=c.fp_m, max_steps=c.fp_max_steps)
        return f(f(f(z_star)))

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
