"""DEQ layer: the fixed-point trajectory-proposal network.

Port of `make_implicit_fp`, `DEQLayerConfig`, `DEQLayer` and `FFDNetwork`
(`deqmpc_tpu/models/deq_layer.py:41-311`): the input encoder embeds the
observation and the carried trajectory, `_fixed_point` solves for the
cell's fixed point, and `_decode` turns the (T-1) x nx head output into
the reference trajectory. Both trunks are
here: "gcn" (convolutions over the horizon, z (B, T-1, hdim)) and "mlp"
(a flat hidden state, z (B, hdim), the input the flattened trajectory).

Obstacle-aware input (`deq_layer.py:168-191`): with `obstacle_centers`
(the env's field, (N, 3)), each knot of the carried trajectory adds the
offsets to its OBSTACLE_N_SEL nearest spheres and their clearances
(distance - radius) as input channels: an extra stream of the gcn
encoder, more flat inputs of the mlp one. Nearest first, a tie going to
the lower index, as `lax.top_k` orders them; the offsets and clearances
are clipped to +-OBSTACLE_RANGE after the clearance is taken.

The fixed point by `fp_type` and `grad_type` (`deq_layer.py:223-272`):

- "single": one cell application to the carried z, with its gradient
  (the feed-forward `FFDNetwork` of deq-mpc-nn);
- "multi": `inner_deq_iters` applications; with `grad_type`
  "last_step_grad" all but the last without a gradient, with any other
  `grad_type` all with it (backpropagation through the iterations);
- "anderson", and any other value "broyden": the solver runs under
  `torch.no_grad()` from a detached z and its best iterate is detached;
  then, with `grad_type` "implicit", that iterate z* is the output and
  `ImplicitFixedPoint` gives the true DEQ gradient; with any other
  `grad_type` ("fp_grad", "bptt", a free string as in JAX) the cell is
  applied three more times with the gradient (the phantom gradient).
  Either way no gradient reaches the incoming z. Broyden takes
  `fp_max_steps`, Anderson also `fp_m`.

`_fixed_point` returns (z, stats): the solver's mean best error and mean
best step ("fwd_err", "fwd_steps"), None without a solver; each round's
aux carries them as "deq_fwd_err" and "deq_fwd_steps".
`compute_dtype=torch.bfloat16` runs the trunk's matmuls in bf16
(`models/blocks.py`).

Decode convention (`deq_layer.py:274-285`): positions integrate from the
current state (x_ref_pos = x0_pos + dq*dt), velocities are direct
predictions, and the observation is prepended as knot 0.

`step(obs, aux)` is one round of the policy loop, as the JAX layer's
`__call__`: `aux` carries "x", "u", "z" and "iter" (and a variant's own
streams) in, and the round's back out. The base layer keeps `iter_emb`
in its parameters and reads none of it (`deq_layer.py:152-160`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..solvers.fp import anderson, broyden
from .blocks import (ConvCell, ConvInput, ConvOutput, GroupNorm, LayerNorm, MLPCell, MLPInput,
                     MLPOutput, UnfoldConv)


def adjoint_solve(vjp_z, g, solver, kw):
    """The backward's transpose fixed point w = (df/dz)' w + g, by the
    forward's solver with its settings, started from g."""
    w, _ = solver(lambda ww: vjp_z(ww) + g, g, **kw)
    return w


class ImplicitFixedPoint(torch.autograd.Function):
    """The fixed-point solve with the true implicit backward
    (`make_implicit_fp`, `deq_layer.py:41-76`, a `custom_vjp` there).

    Forward: z* = solver(f) from z0 without a gradient, f(z) =
    cell(inj, z), and the solver's best errors and steps; z* is the
    output, with no further cell application. Backward: w solves
    w = (df/dz)' w + g with the same solver and settings, started from g
    (`adjoint_solve`), then one VJP of f at z* hands w on to the cell's
    parameters and to `inj`; z0 gets zeros. The backward runs the cell
    again on detached copies, so it can run as often as the graph is
    retained."""

    @staticmethod
    def forward(ctx, cell, solver, kw, inj, z0, *params):
        with torch.no_grad():
            z_star, info = solver(lambda zz: cell(inj, zz), z0.detach(), **kw)
        ctx.cell, ctx.solver, ctx.kw = cell, solver, kw
        ctx.save_for_backward(inj, z_star, *params)
        ctx.mark_non_differentiable(info.best_err, info.best_step)
        return z_star, info.best_err, info.best_step

    @staticmethod
    def backward(ctx, g, _err, _step):
        inj, z_star, *params = ctx.saved_tensors
        names = [n for n, _ in ctx.cell.named_parameters()]
        with torch.enable_grad():
            inj_d = inj.detach().requires_grad_()
            z_d = z_star.detach().requires_grad_()
            p_d = [p.detach().requires_grad_() for p in params]
            fz = torch.func.functional_call(ctx.cell, dict(zip(names, p_d)), (inj_d, z_d))

            def vjp_z(ww):
                return torch.autograd.grad(fz, z_d, ww, retain_graph=True)[0]

            w = adjoint_solve(vjp_z, g, ctx.solver, ctx.kw)
            grads = torch.autograd.grad(fz, [inj_d, *p_d], w, allow_unused=True)
        return (None, None, None, grads[0], torch.zeros_like(z_star), *grads[1:])


@dataclasses.dataclass(frozen=True)
class DEQLayerConfig:
    nx: int
    nu: int
    nq: int
    T: int
    dt: float
    hdim: int = 128
    layer_type: str = "gcn"  # or "mlp"
    deq_iter: int = 6
    fp_m: int = 5
    fp_max_steps: int = 10
    kernel_width: int = 3
    deq_expand: int = 4
    num_groups: int = 4
    fp_type: str = "anderson"  # "single" | "multi" | "broyden" | "anderson"
    inner_deq_iters: int = 4   # the cell applications of fp_type "multi"
    # "fp_grad" (the phantom gradient), "implicit", "last_step_grad", or any
    # other string, which takes the default branch as in JAX
    grad_type: str = "fp_grad"
    # the trunk's matmul dtype: None (the parameters'), or torch.bfloat16
    compute_dtype: Any = None
    # the obstacle-aware input: the field's centers (N, 3), or None
    obstacle_centers: Any = None
    obstacle_radius: float = 0.0


def fp_stats(best_err, best_step) -> Dict:
    """A solve's stats as JAX reports them: the mean best error, and the
    mean best step in f32."""
    return {"fwd_err": best_err.mean(), "fwd_steps": best_step.to(torch.float32).mean()}


def stats_aux(stats: Dict) -> Dict:
    """The stats as a round's aux carries them."""
    return {"deq_fwd_err": stats["fwd_err"], "deq_fwd_steps": stats["fwd_steps"]}


# the obstacle-aware input's spheres per knot (the solver's rows select as
# many) and the clip of its offsets and clearances (`deq_layer.py:110-111`)
OBSTACLE_N_SEL = 4
OBSTACLE_RANGE = 5.0


class DEQLayer(nn.Module):
    """Base DEQ layer: state-prediction output (deq_out_type=1)."""

    def __init__(self, cfg: DEQLayerConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.obstacle_centers is not None:
            # not a parameter: outside the state dict, moved with the module
            self.register_buffer("obstacle_centers", torch.as_tensor(
                np.asarray(cfg.obstacle_centers), dtype=torch.float64), persistent=False)
        self._build()

    def _build(self):
        c = self.cfg
        n_feat = 4 * OBSTACLE_N_SEL if c.obstacle_centers is not None else 0
        dt = c.compute_dtype
        if c.layer_type == "mlp":
            self.input = MLPInput(c.T * c.nx + (c.T - 1) * n_feat, c.hdim)
            self.cell = MLPCell(c.hdim, c.deq_expand, dt)
            self.out = MLPOutput(c.hdim, c.nx * (c.T - 1))
            self.iter_emb = nn.Parameter(torch.zeros(c.deq_iter, c.hdim))
        elif c.layer_type == "gcn":
            self.input = ConvInput(nx=c.nx, obs_dim=c.nx, hdim=c.hdim, horizon=c.T - 1,
                                   kernel_width=c.kernel_width, num_groups=c.num_groups,
                                   extra_dim=n_feat, dtype=dt)
            self.cell = ConvCell(hdim=c.hdim, expand=c.deq_expand,
                                 kernel_width=c.kernel_width, num_groups=c.num_groups, dtype=dt)
            self.out = ConvOutput(out_dim=c.nx, hdim=c.hdim, kernel_width=c.kernel_width,
                                  num_groups=c.num_groups, dtype=dt)
            # per-iteration embedding: in the checkpoint, unused by the base
            # forward exactly as in the JAX package
            self.iter_emb = nn.Parameter(torch.zeros(c.deq_iter, c.T - 1, c.hdim))
        else:
            raise NotImplementedError(c.layer_type)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Seeded initialisation for a fresh run. Every draw is made on the
        CPU from `generator`, so one seed gives the same weights on any
        device. The distributions are flax's (`models/blocks.py` of the
        JAX package): Dense and conv kernels lecun-normal (a normal
        truncated at two standard deviations, variance 1/fan_in), time
        embeddings N(0, 1), biases, norm offsets and `iter_emb` zero, norm
        scales and the Delta variant's `scales` one. The draws are not
        flax's: a port run and a JAX run from the same seed start from
        different weights."""

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
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "time_emb":
                p.copy_(torch.randn(p.shape, generator=generator, dtype=torch.float64))
            elif leaf == "iter_emb":
                p.zero_()
            elif leaf == "scales":
                p.fill_(1.0)

    def _like(self):
        return next(self.parameters())

    def init_z(self, bsz: int, dtype=None, device=None):
        c = self.cfg
        p = self._like()
        shape = (bsz, c.hdim) if c.layer_type == "mlp" else (bsz, c.T - 1, c.hdim)
        return torch.zeros(shape, dtype=dtype or p.dtype, device=device or p.device)

    def _obstacle_feats(self, x_knots):
        """Per-knot features of the n_sel nearest spheres: the clipped center
        offsets (3k) and clearances (k), (B, T-1, 4k)."""
        c = self.cfg
        centers = self.obstacle_centers.to(x_knots.dtype)                # (N, 3)
        pos = x_knots[..., :3]                                           # (B, T-1, 3)
        d2 = torch.sum((pos[..., None, :] - centers) ** 2, dim=-1)       # (B, T-1, N)
        # nearest first, ties to the lower index (a stable sort), as lax.top_k
        idx = torch.sort(d2.detach(), dim=-1, stable=True).indices[..., :OBSTACLE_N_SEL]
        off = centers[idx] - pos[..., None, :]                           # (B, T-1, k, 3)
        clear = torch.linalg.vector_norm(off, dim=-1) - c.obstacle_radius
        r = OBSTACLE_RANGE
        off, clear = torch.clamp(off, -r, r), torch.clamp(clear, -r, r)
        return torch.cat([off.flatten(-2), clear], dim=-1)

    def _input(self, obs, x_prev, extra=()):
        """The input injection from the observation and the carried
        trajectory (and a variant's `extra` streams), with the obstacle
        features when the layer has a field."""
        if self.cfg.obstacle_centers is not None:
            extra = (*extra, self._obstacle_feats(x_prev[:, 1:]))
        if self.cfg.layer_type == "mlp":
            bsz = x_prev.shape[0]
            return self.input(torch.cat([x_prev.reshape(bsz, -1),
                                         *[e.reshape(bsz, -1) for e in extra]], dim=-1))
        return self.input(x_prev[:, 1:], obs, extra)

    def _solver(self):
        """The accelerated solver of fp_type and its settings (any fp_type
        but "anderson" is Broyden, as in JAX)."""
        c = self.cfg
        if c.fp_type == "anderson":
            return anderson, dict(m=c.fp_m, max_steps=c.fp_max_steps)
        return broyden, dict(max_steps=c.fp_max_steps)

    def _fixed_point(self, inj, z):
        """The round's fixed point by fp_type and grad_type (see the module
        docstring). Returns (z_out, {"fwd_err", "fwd_steps"})."""
        c = self.cfg

        def f(zz):
            return self.cell(inj, zz)

        stats = {"fwd_err": None, "fwd_steps": None}
        if c.fp_type == "single":
            return f(z), stats
        if c.fp_type == "multi":
            for i in range(c.inner_deq_iters):
                if c.grad_type == "last_step_grad" and i < c.inner_deq_iters - 1:
                    with torch.no_grad():
                        z = f(z)
                else:
                    z = f(z)
            return z, stats
        solver, kw = self._solver()
        if c.grad_type == "implicit":
            z_star, best_err, best_step = ImplicitFixedPoint.apply(
                self.cell, solver, kw, inj, z, *self.cell.parameters())
            return z_star, fp_stats(best_err, best_step)
        with torch.no_grad():
            z_star, info = solver(f, z.detach(), **kw)
        # the phantom gradient: three re-engaged applications
        return f(f(f(z_star.detach()))), fp_stats(info.best_err, info.best_step)

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
        """One round (`deq_layer.py:287-302`): aux {"x", "z", "iter", ...}
        -> ({"x_t", "x_ref", "u_ref"}, {"x", "u", "z", "iter",
        "deq_fwd_err", "deq_fwd_steps"})."""
        x_prev = aux["x"]
        z_out, stats = self._fixed_point(self._input(obs, x_prev), aux["z"])
        x_ref, u_ref = self._decode(obs, x_prev, self.out(z_out))
        return ({"x_t": obs, "x_ref": x_ref, "u_ref": u_ref},
                {"x": x_ref, "u": u_ref, "z": z_out, "iter": aux.get("iter", 0),
                 **stats_aux(stats)})

    def forward(self, obs, x_prev, z) -> Tuple[Dict, torch.Tensor]:
        """obs (bsz, nx), x_prev (bsz, T, nx), z (bsz, T-1, hdim), or
        (bsz, hdim) for the mlp trunk -> ({"x_t", "x_ref", "u_ref"}, z_out)."""
        out_mpc, aux = self.step(obs, {"x": x_prev, "z": z})
        return out_mpc, aux["z"]


class FFDNetwork(DEQLayer):
    """The feed-forward proposal network of deq_type "nn"
    (`deq_layer.py:305-311`): the same trunk, one un-accelerated cell
    application per round."""

    def __init__(self, cfg: DEQLayerConfig):
        super().__init__(dataclasses.replace(cfg, fp_type="single"))
