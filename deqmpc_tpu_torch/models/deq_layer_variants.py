"""DEQ layer variants: the networks of the policy-variant family.

Port of `deqmpc_tpu/models/deq_layer_variants.py:40-701`:

- `DEQLayerMem`: a memory stream in the gcn input encoder and a
  `GatedResidual` memory update, bypassed (it returns z) as in the JAX
  package and the reference.
- `DEQLayerDelta`: mlp trunk, one cell application a round; learned
  per-iteration output scales through the straight-through
  `scale_multiply_st`, per-iteration z embeddings, deltas relative to the
  previous prediction.
- `DEQLayerHistoryState`: an H-step observation history in, a two-branch
  estimation/prediction gcn cell (`EstPredCell`), z a pair
  (z_est (B, H, h), z_pred (B, T, h)); x_t is the estimated current state.
- `DEQLayerHistoryStateEstPred`: adds the estimate x_est as an input
  stream and an estimation head; pairs with the MHE estimator.
- `DEQLayerHistory`: joint state and action output from the history, mlp.
- `DEQLayerFeedback`: the optimizer's and the network's trajectories in.
- `DEQLayerQ`: also emits per-knot Q scalings (ReLU, knot 0 pinned to 1).

Every layer's `step(obs, aux)` is one round, as the JAX `__call__`; the
variants with iteration embeddings clamp `aux["iter"]` to deq_iter - 1.
Submodules carry the names of the JAX parameter tree, so
`utils/checkpoint.params_from_jax` maps it one to one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch
from torch import nn

from ..solvers.fp import anderson
from .blocks import (ConvOutput, GatedResidual, GroupNorm, LayerNorm, MLPCell, MLPInput,
                     MLPOutput, UnfoldConv, get_act)
from .deq_layer import DEQLayer, DEQLayerConfig, fp_stats, stats_aux


class _ScaleMultiplyST(torch.autograd.Function):
    """out = x * s; backward dx = g (the identity, straight through) and
    ds = g * x (`deq_layer_variants.py:40-54`)."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.save_for_backward(x)
        return x * s

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g, g * x


def scale_multiply_st(x, s):
    return _ScaleMultiplyST.apply(x, s)


# -- blocks of the variants ------------------------------------------------------

class StreamConvInput(nn.Module):
    """gcn input encoder over feature streams of a length-`horizon`
    sequence: the streams and a learned time embedding (`n_streams`
    counts it) concatenated, conv to mid_mult*hdim, act, conv to hdim,
    GroupNorm."""

    def __init__(self, hdim: int, horizon: int, n_streams: int, mid_mult: int = 4,
                 kernel_width: int = 3, num_groups: int = 4, act: str = "relu"):
        super().__init__()
        self.act = get_act(act)
        self.time_emb = nn.Parameter(torch.randn(horizon, hdim))
        self.Conv_0 = UnfoldConv(n_streams * hdim, mid_mult * hdim, kernel_width)
        self.Conv_1 = UnfoldConv(mid_mult * hdim, hdim, kernel_width)
        self.GroupNorm_0 = GroupNorm(hdim, num_groups)

    def forward(self, streams: Sequence[torch.Tensor]):
        t = self.time_emb[None].expand(streams[0].shape[0], -1, -1)
        inp = self.act(self.Conv_0(torch.cat([*streams, t], dim=-1)))
        return self.GroupNorm_0(self.Conv_1(inp))


class NodeEncoder(nn.Module):
    """act(LayerNorm(Dense(x)))."""

    def __init__(self, in_dim: int, hdim: int, act: str = "relu"):
        super().__init__()
        self.act = get_act(act)
        self.Dense_0 = nn.Linear(in_dim, hdim)
        self.LayerNorm_0 = LayerNorm(hdim)

    def forward(self, x):
        return self.act(self.LayerNorm_0(self.Dense_0(x)))


class EstPredCell(nn.Module):
    """Two-branch est/pred residual conv cell: the estimation branch runs
    over the H history knots, and its last knot's embedding, mapped by
    Dense_0, is injected into every knot of the prediction branch. Norms
    named in flax's order (the outer one before the inner)."""

    def __init__(self, hdim: int, expand: int = 4, kernel_width: int = 3,
                 num_groups: int = 4, act: str = "mish"):
        super().__init__()
        self.act = get_act(act)
        wide = hdim * expand
        for b in (0, 2):  # the estimation branch's layers, then the prediction's
            setattr(self, f"Conv_{b}", UnfoldConv(hdim, wide, kernel_width))
            setattr(self, f"Conv_{b + 1}", UnfoldConv(wide, hdim, kernel_width))
        for i, width in enumerate((wide, hdim, hdim) * 2):
            setattr(self, f"GroupNorm_{i}", GroupNorm(width, num_groups))
        self.Dense_0 = nn.Linear(hdim, hdim)

    def _branch(self, i, x_inj, z):
        """GN_{3i+1}(act(z + GN_{3i+2}(x_inj + Conv_{2i+1}(GN_{3i}(act(Conv_{2i}(z)))))))."""
        gn = lambda k: getattr(self, f"GroupNorm_{3 * i + k}")  # noqa: E731
        y = gn(0)(self.act(getattr(self, f"Conv_{2 * i}")(z)))
        return gn(1)(self.act(z + gn(2)(x_inj + getattr(self, f"Conv_{2 * i + 1}")(y))))

    def forward(self, x_inj, z):
        (x_est, x_pred), (z_est, z_pred) = x_inj, z
        out_est = self._branch(0, x_est, z_est)
        z_est_out = self.Dense_0(out_est[:, -1])[:, None, :]
        return out_est, self._branch(1, x_pred + z_est_out, z_pred)


def _iter(aux, cfg):
    return min(int(aux.get("iter", 0)), cfg.deq_iter - 1)


def _expand_knots(e, T):
    return e[:, None].expand(-1, T, -1)


# -- variants --------------------------------------------------------------------

class DEQLayerMem(DEQLayer):
    """A memory stream in the input (gcn only) and the bypassed gated
    memory update. Its input reads neither the iteration embedding nor an
    obstacle field."""

    def __init__(self, cfg: DEQLayerConfig, mem_bypass: bool = True):
        self.mem_bypass = mem_bypass
        super().__init__(dataclasses.replace(cfg, obstacle_centers=None))

    def _build(self):
        super()._build()
        c = self.cfg
        if c.layer_type == "gcn":
            self.input = nn.Module()
            self.input.node = NodeEncoder(c.nx, c.hdim)
            self.input.x0 = NodeEncoder(c.nx, c.hdim)
            self.input.enc = StreamConvInput(c.hdim, c.T - 1, n_streams=4, mid_mult=4,
                                             kernel_width=c.kernel_width,
                                             num_groups=c.num_groups)
        self.mem1 = GatedResidual(c.hdim, self.mem_bypass)
        self.mem2 = GatedResidual(c.hdim, self.mem_bypass)

    def init_mem(self, bsz: int, dtype=None, device=None):
        return self.init_z(bsz, dtype, device)

    def _input(self, obs, x_prev, extra=()):
        c = self.cfg
        if c.layer_type == "mlp":
            return self.input(x_prev.reshape(x_prev.shape[0], -1))
        ne = self.input.node(x_prev[:, 1:])
        x0 = _expand_knots(self.input.x0(obs), c.T - 1)
        return self.input.enc([ne, x0, *extra])

    def step(self, obs, aux: Dict):
        """A round with the memory update (JAX's `mem_update=True`; the
        other value serves the cost refresh, which waits for a later slice)."""
        c = self.cfg
        x_prev, mem = aux["x"], aux["mem"]
        inj = self._input(obs, x_prev, (mem,) if c.layer_type == "gcn" else ())
        z_out, stats = self._fixed_point(inj, aux["z"])
        x_ref, u_ref = self._decode(obs, x_prev, self.out(z_out))
        new_mem = z_out if self.mem_bypass else self.mem2(self.mem1(mem, z_out), z_out)
        return ({"x_t": obs, "x_ref": x_ref, "u_ref": u_ref},
                {"x": x_ref, "u": u_ref, "z": z_out, "iter": aux.get("iter", 0),
                 "mem": new_mem, "old_mem": mem, **stats_aux(stats)})


class DEQLayerDelta(DEQLayer):
    """Per-iteration output scales and z embeddings; deltas relative to the
    previous prediction. The mlp trunk and one cell application a round,
    whatever the config says."""

    def __init__(self, cfg: DEQLayerConfig):
        super().__init__(dataclasses.replace(cfg, layer_type="mlp", fp_type="single"))
        c = self.cfg
        self.scales = nn.Parameter(torch.ones(c.deq_iter, c.T - 1, c.nx))

    def step(self, obs, aux: Dict):
        c = self.cfg
        x_prev = aux["x"]
        it = _iter(aux, c)
        z_out, stats = self._fixed_point(self._input(obs, x_prev),
                                         aux["z"] + self.iter_emb[it][None])
        out = self.out(z_out)
        scale = self.scales[it]
        scale = torch.cat([scale[:, : c.nq] / c.dt, scale[:, c.nq:]], dim=-1)  # (T-1, nx)
        out = scale_multiply_st(out, scale.reshape(-1)[None].expand_as(out))
        bsz = obs.shape[0]
        dx = out.reshape(bsz, c.T - 1, c.nx)
        pos = dx[..., : c.nq] * c.dt + x_prev[:, 1:, : c.nq]
        vel = dx[..., c.nq:] + x_prev[:, 1:, c.nq:]
        x_ref = torch.cat([obs[:, None, :], torch.cat([pos, vel], dim=-1)], dim=-2)
        u_ref = torch.zeros((bsz, c.T, c.nu), dtype=x_ref.dtype, device=x_ref.device)
        return ({"x_t": obs, "x_ref": x_ref, "u_ref": u_ref, "s": scale.abs().mean()},
                {"x": x_ref, "u": u_ref, "z": z_out, "iter": it, **stats_aux(stats)})


class DEQLayerHistoryState(DEQLayer):
    """Observation-history input and the est/pred two-branch gcn cell (the
    gcn trunk whatever the config says); no iteration embedding."""

    def __init__(self, cfg: DEQLayerConfig, H: int):
        self.H = H
        super().__init__(dataclasses.replace(cfg, layer_type="gcn", obstacle_centers=None))

    def _build(self):
        c, H = self.cfg, self.H
        kw = dict(kernel_width=c.kernel_width, num_groups=c.num_groups, act="mish")
        self.node = NodeEncoder(c.nx, c.hdim, act="mish")
        self.obs_enc = StreamConvInput(c.hdim, H, n_streams=2, mid_mult=2, **kw)
        self.pred_enc = StreamConvInput(c.hdim, c.T, n_streams=3, mid_mult=3, **kw)
        self.cell = EstPredCell(c.hdim, c.deq_expand, c.kernel_width, c.num_groups)
        self.out = ConvOutput(out_dim=c.nx, hdim=c.hdim, kernel_width=c.kernel_width,
                              num_groups=c.num_groups)

    def init_z(self, bsz: int, dtype=None, device=None):
        c, p = self.cfg, self._like()
        kw = dict(dtype=dtype or p.dtype, device=device or p.device)
        return (torch.zeros((bsz, self.H, c.hdim), **kw), torch.zeros((bsz, c.T, c.hdim), **kw))

    def _encode(self, obs_hist, aux):
        c = self.cfg
        obs_inp = self.obs_enc([self.node(obs_hist)])
        x0 = obs_inp[:, -1:].expand(-1, c.T, -1)
        return obs_inp, self.pred_enc([self.node(aux["x"]), x0])

    def _fixed_point(self, inj, z):
        """The tuple fixed point, with JAX's own rules
        (`deq_layer_variants.py:341-378`): "single" one cell application,
        "multi" `inner_deq_iters` of them, all with the gradient whatever
        `grad_type` says; any other fp_type, "broyden" included, Anderson
        on the pair flattened into one vector, then three cell applications
        with the gradient ("implicit" is not taken here)."""
        c = self.cfg

        def f(zz):
            return self.cell(inj, zz)

        if c.fp_type in ("single", "multi"):
            for _ in range(1 if c.fp_type == "single" else c.inner_deq_iters):
                z = f(z)
            return z, {"fwd_err": None, "fwd_steps": None}
        bsz = z[0].shape[0]
        n0, shapes = z[0][0].numel(), (z[0].shape, z[1].shape)

        def f_flat(zf):
            oa, ob = f((zf[:, :n0].reshape(shapes[0]), zf[:, n0:].reshape(shapes[1])))
            return torch.cat([oa.reshape(bsz, -1), ob.reshape(bsz, -1)], dim=1)

        with torch.no_grad():
            zf0 = torch.cat([z[0].reshape(bsz, -1), z[1].reshape(bsz, -1)], dim=1)
            zs, info = anderson(f_flat, zf0, m=c.fp_m, max_steps=c.fp_max_steps)
        zt = (zs[:, :n0].reshape(shapes[0]), zs[:, n0:].reshape(shapes[1]))
        return f(f(f(zt))), fp_stats(info.best_err, info.best_step)

    def _history(self, obs_hist):
        return obs_hist.reshape(obs_hist.shape[0], self.H, self.cfg.nx)

    def _knots(self, d, base):
        """Knot-wise deltas: positions d*dt + base, velocities d."""
        nq = self.cfg.nq
        return torch.cat([d[..., :nq] * self.cfg.dt + base[..., :nq], d[..., nq:]], dim=-1)

    def step(self, obs_hist, aux: Dict):
        c = self.cfg
        obs_hist = self._history(obs_hist)
        z_out, stats = self._fixed_point(self._encode(obs_hist, aux), aux["z"])
        x_ref = self._knots(self.out(z_out[1]), aux["x"])
        u_ref = torch.zeros((x_ref.shape[0], c.T, c.nu), dtype=x_ref.dtype, device=x_ref.device)
        return ({"x_t": x_ref[:, 0], "x_ref": x_ref, "u_ref": u_ref},
                {"x": x_ref, "u": u_ref, "z": z_out, "iter": aux.get("iter", 0),
                 **stats_aux(stats)})


class DEQLayerHistoryStateEstPred(DEQLayerHistoryState):
    """The estimate x_est as a further input stream, the last estimation
    knot's latent as the prediction's x0 stream, and an estimation head."""

    def _build(self):
        super()._build()
        c = self.cfg
        self.obs_enc = StreamConvInput(c.hdim, self.H, n_streams=3, mid_mult=3,
                                       kernel_width=c.kernel_width, num_groups=c.num_groups,
                                       act="mish")
        self.z0_enc = NodeEncoder(c.hdim, c.hdim, act="mish")
        self.out_est = ConvOutput(out_dim=c.nx, hdim=c.hdim, kernel_width=c.kernel_width,
                                  num_groups=c.num_groups)

    def _encode(self, obs_hist, aux):
        c = self.cfg
        x_est = self._history(aux["x_est"])
        obs_inp = self.obs_enc([self.node(obs_hist), self.node(x_est)])
        x0 = _expand_knots(self.z0_enc(aux["z"][0][:, -1]), c.T)
        return obs_inp, self.pred_enc([self.node(aux["x"]), x0])

    def step(self, obs_hist, aux: Dict):
        out_mpc, new_aux = super().step(obs_hist, aux)
        obs_hist = self._history(obs_hist)
        d_est = self.out_est(new_aux["z"][0])  # (B, H, nx)
        nq = self.cfg.nq
        x_est = torch.cat([d_est[..., :nq] * self.cfg.dt + obs_hist[..., :nq],
                           d_est[..., nq:] + obs_hist[..., nq:]], dim=-1)
        return {**out_mpc, "x_est": x_est}, {**new_aux, "x_est": x_est}


class DEQLayerHistory(DEQLayer):
    """Joint state and action output from the history, the previous
    trajectory and its actions (mlp trunk whatever the config says); no
    iteration embedding."""

    def __init__(self, cfg: DEQLayerConfig, H: int):
        self.H = H
        super().__init__(dataclasses.replace(cfg, layer_type="mlp", obstacle_centers=None))

    def _build(self):
        c = self.cfg
        self.input = MLPInput(c.nx * self.H + c.nx * c.T + c.nu * (c.T - 1), c.hdim)
        self.cell = MLPCell(c.hdim, c.deq_expand, c.compute_dtype)
        self.out = MLPOutput(c.hdim, c.nx * c.T + c.nu * (c.T - 1))

    def step(self, obs_hist, aux: Dict):
        c = self.cfg
        x_prev, u_prev = aux["x"], aux["u"]
        bsz = obs_hist.shape[0]
        flat = torch.cat([obs_hist.reshape(bsz, -1), x_prev.reshape(bsz, -1),
                          u_prev[:, : c.T - 1].reshape(bsz, -1)], dim=-1)
        z_out, stats = self._fixed_point(self.input(flat), aux["z"])
        out = self.out(z_out)
        d_x = out[..., : c.nx * c.T].reshape(bsz, c.T, c.nx)
        u_ref = out[..., c.nx * c.T:].reshape(bsz, c.T - 1, c.nu)
        u_ref = torch.cat([u_ref, torch.zeros_like(u_ref[:, -1:])], dim=1)
        x_ref = torch.cat([d_x[..., : c.nq] * c.dt + x_prev[..., : c.nq], d_x[..., c.nq:]],
                          dim=-1)
        return ({"x_t": x_ref[:, 0], "x_ref": x_ref, "u_ref": u_ref},
                {"x": x_ref, "u": u_ref, "z": z_out, "iter": aux.get("iter", 0),
                 **stats_aux(stats)})


class DEQLayerFeedback(DEQLayer):
    """The optimizer's trajectory x and the network's xn both in: mlp on
    [xn, x] (2*T*nx wide), gcn on two node streams and the x0 stream. No
    obstacle field."""

    def __init__(self, cfg: DEQLayerConfig):
        super().__init__(dataclasses.replace(cfg, obstacle_centers=None))

    def _build(self):
        super()._build()
        c = self.cfg
        if c.layer_type == "mlp":
            self.input = MLPInput(2 * c.T * c.nx, c.hdim)
            return
        del self.input
        self.node = NodeEncoder(c.nx, c.hdim, act="mish")
        self.x0 = NodeEncoder(c.nx, c.hdim, act="mish")
        self.enc = StreamConvInput(c.hdim, c.T - 1, n_streams=4, mid_mult=4,
                                   kernel_width=c.kernel_width, num_groups=c.num_groups,
                                   act="mish")

    def step(self, obs, aux: Dict):
        c = self.cfg
        x = aux["x"]
        xn = aux.get("xn", x)
        it = _iter(aux, c)
        bsz = obs.shape[0]
        if c.layer_type == "mlp":
            inj = self.input(torch.cat([xn.reshape(bsz, -1), x.reshape(bsz, -1)], dim=-1))
        else:
            inj = self.enc([self.node(x[:, 1:]), self.node(xn[:, 1:]),
                            _expand_knots(self.x0(obs), c.T - 1)])
        z_out, stats = self._fixed_point(inj, aux["z"] + self.iter_emb[it][None])
        x_ref, u_ref = self._decode(obs, x, self.out(z_out))
        return ({"x_t": obs, "x_ref": x_ref, "u_ref": u_ref},
                {"xn": x_ref, "x": x_ref, "u": u_ref, "z": z_out, "iter": it,
                 **stats_aux(stats)})


class DEQLayerQ(DEQLayer):
    """The state prediction and per-knot Q scalings (ReLU, knot 0 pinned
    to 1), with the previous scalings as an input. No obstacle field."""

    def __init__(self, cfg: DEQLayerConfig):
        super().__init__(dataclasses.replace(cfg, obstacle_centers=None))

    def _build(self):
        super()._build()
        c = self.cfg
        if c.layer_type == "mlp":
            self.input = MLPInput(c.T * c.nx + c.T, c.hdim)
            self.out = MLPOutput(c.hdim, c.nx * (c.T - 1) + c.T)
            return
        del self.input
        self.node = NodeEncoder(c.nx + 1, c.hdim, act="mish")
        self.x0 = NodeEncoder(c.nx, c.hdim, act="mish")
        self.enc = StreamConvInput(c.hdim, c.T - 1, n_streams=3, mid_mult=4,
                                   kernel_width=c.kernel_width, num_groups=c.num_groups,
                                   act="mish")
        self.out = ConvOutput(out_dim=c.nx + 1, hdim=c.hdim, kernel_width=c.kernel_width,
                              num_groups=c.num_groups)

    def step(self, obs, aux: Dict):
        c = self.cfg
        x_prev = aux["x"]
        it = _iter(aux, c)
        bsz = obs.shape[0]
        q3 = aux["q"].reshape(bsz, c.T, 1)
        if c.layer_type == "mlp":
            inj = self.input(torch.cat([x_prev.reshape(bsz, -1), q3.reshape(bsz, -1)], dim=-1))
        else:
            xq = torch.cat([x_prev, q3], dim=-1)
            inj = self.enc([self.node(xq[:, 1:]), _expand_knots(self.x0(obs), c.T - 1)])
        z_out, stats = self._fixed_point(inj, aux["z"] + self.iter_emb[it][None])
        out = self.out(z_out)
        if c.layer_type == "mlp":
            dx = out[..., : c.nx * (c.T - 1)]
            q_out = torch.relu(out[..., c.nx * (c.T - 1):])[:, : c.T - 1]
        else:
            dx = out[..., : c.nx]
            q_out = torch.relu(out[..., c.nx]).reshape(bsz, c.T - 1)
        q_out = torch.cat([torch.ones_like(q_out[:, :1]), q_out], dim=1)
        x_ref, u_ref = self._decode(obs, x_prev, dx)
        return ({"x_t": obs, "x_ref": x_ref, "u_ref": u_ref, "q": q_out},
                {"x": x_ref, "u": u_ref, "z": z_out, "q": q_out, "iter": it,
                 **stats_aux(stats)})
