"""DEQ layer: the fixed-point trajectory-proposal network over the gcn trunk
(`deqmpc_tpu/models/deq_layer.py`).

The input encoder embeds the observation and the carried trajectory, the
fixed point of the cell is found, and `_decode` turns the (T-1) x nx head
output into the reference trajectory. The fixed point by `fp_type`:

- "single": one cell application to the carried z (the feed-forward
  `FFDNetwork` of deq-mpc-nn);
- "anderson": Anderson's solver from the carried z without a gradient,
  then the cell applied three more times to its best iterate (the phantom
  gradient's applications, which the forward keeps).

Decode convention: positions integrate from the current state
(x_ref_pos = x0_pos + dq*dt), velocities are direct predictions, and the
observation is prepended as knot 0. `step(obs, aux)` is one round of the
policy loop: `aux` carries "x" and "z" in, and the round's back out.
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
    fp_type: str = "anderson"  # or "single"


class DEQLayer(nn.Module):
    """Base DEQ layer: state-prediction output."""

    def __init__(self, cfg: DEQLayerConfig):
        super().__init__()
        if cfg.fp_type not in ("anderson", "single"):
            raise NotImplementedError(f"the reference has no fp_type {cfg.fp_type!r}")
        self.cfg = c = cfg
        self.input = ConvInput(nx=c.nx, obs_dim=c.nx, hdim=c.hdim, horizon=c.T - 1,
                               kernel_width=c.kernel_width, num_groups=c.num_groups)
        self.cell = ConvCell(hdim=c.hdim, expand=c.deq_expand,
                             kernel_width=c.kernel_width, num_groups=c.num_groups)
        self.out = ConvOutput(out_dim=c.nx, hdim=c.hdim, kernel_width=c.kernel_width,
                              num_groups=c.num_groups)
        # per-iteration embedding: in the checkpoint, unused by the base
        # forward exactly as in the JAX package
        self.iter_emb = nn.Parameter(torch.zeros(c.deq_iter, c.T - 1, c.hdim))

    def init_z(self, bsz: int, dtype, device):
        c = self.cfg
        return torch.zeros((bsz, c.T - 1, c.hdim), dtype=dtype, device=device)

    def _fixed_point(self, inj, z):
        def f(zz):
            return self.cell(inj, zz)

        if self.cfg.fp_type == "single":
            return f(z)
        with torch.no_grad():
            z_star = anderson(f, z.detach(), m=self.cfg.fp_m, max_steps=self.cfg.fp_max_steps)
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

    def step(self, obs, aux: Dict) -> Tuple[Dict, Dict]:
        """One round: aux {"x", "z"} -> ({"x_t", "x_ref", "u_ref"},
        {"x", "u", "z"})."""
        x_prev = aux["x"]
        z_out = self._fixed_point(self.input(x_prev[:, 1:], obs), aux["z"])
        x_ref, u_ref = self._decode(obs, x_prev, self.out(z_out))
        return ({"x_t": obs, "x_ref": x_ref, "u_ref": u_ref},
                {"x": x_ref, "u": u_ref, "z": z_out})


class FFDNetwork(DEQLayer):
    """The feed-forward proposal network of deq_type "nn": the same trunk,
    one un-accelerated cell application per round."""

    def __init__(self, cfg: DEQLayerConfig):
        super().__init__(dataclasses.replace(cfg, fp_type="single"))
