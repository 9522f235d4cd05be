"""DEQ-MPC policy, the cold forward (`deqmpc_tpu/policies/deqmpc_policy.py`):
N = deq_iter rounds of {network proposal -> AL tracking solve}; the solver's
trajectory feeds the next round's network input, and the AL state (duals,
penalty, iterate) carries from round to round. With `deq_type="nn"`
(deq-mpc-nn) the network is the feed-forward `FFDNetwork`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import torch

from ..models.deq_layer import DEQLayer, DEQLayerConfig, FFDNetwork
from .tracking_mpc import TrackingMPC


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    nx: int
    nu: int
    nq: int
    T: int
    dt: float
    hdim: int = 128
    deq_iter: int = 6
    fp_type: str = "anderson"
    fp_max_steps: int = 10
    fp_m: int = 5
    kernel_width: int = 3
    al_iter: int = 2
    max_newton_steps: int = 4
    rho_max: float = 1e8
    dyn_res_tol: float = 1e-3
    deq_type: str = "deq"    # or "nn": the feed-forward FFDNetwork


class DEQMPCPolicy:
    """`dtype`: the network's and the solver's; the benchmark's f32, or f64
    where a test holds the reference to the JAX package's f64 answers."""

    def __init__(self, cfg: PolicyConfig, env, device="cuda", dtype=torch.float32):
        self.cfg = cfg
        self.nx, self.nu, self.T = cfg.nx, cfg.nu, cfg.T
        self.device = torch.device(device)
        mcfg = DEQLayerConfig(
            nx=cfg.nx, nu=cfg.nu, nq=cfg.nq, T=cfg.T, dt=cfg.dt, hdim=cfg.hdim,
            deq_iter=cfg.deq_iter, fp_type=cfg.fp_type, fp_m=cfg.fp_m,
            fp_max_steps=cfg.fp_max_steps, kernel_width=cfg.kernel_width)
        model = FFDNetwork(mcfg) if cfg.deq_type == "nn" else DEQLayer(mcfg)
        self.model = model.to(self.device, dtype)
        self.tracking_mpc = TrackingMPC(
            env, cfg.T, al_iter=cfg.al_iter, dtype=dtype,
            max_newton_steps=cfg.max_newton_steps,
            rho_max=cfg.rho_max, dyn_res_tol=cfg.dyn_res_tol, device=self.device)

    def _cold_aux(self, x_t) -> Dict:
        """The first round's aux: the current state tiled over the horizon,
        zero actions, a zero latent."""
        bsz = x_t.shape[0]
        return {"x": x_t[:, None].expand(bsz, self.T, self.nx),
                "u": torch.zeros((bsz, self.T, self.nu), dtype=x_t.dtype, device=x_t.device),
                "z": self.model.init_z(bsz, x_t.dtype, x_t.device)}

    def forward(self, obs) -> Dict:
        """obs (bsz, nx) -> {"trajs": [(x_ref, x_opt, u_opt)] * deq_iter}."""
        aux = self._cold_aux(obs)
        sol_state = self.tracking_mpc.init_state(obs.shape[0])
        trajs = []
        for _ in range(self.cfg.deq_iter):
            out_mpc, aux = self.model.step(obs, aux)
            x_t, x_ref, u_ref = out_mpc["x_t"], out_mpc["x_ref"], out_mpc["u_ref"]
            ns, na, sol_state = self.tracking_mpc(x_t, x_ref, u_ref, sol_state,
                                                  al_iters=self.cfg.al_iter)
            # the next round reads the solver's trajectory
            aux = {**aux, "x": ns, "u": na}
            trajs.append((x_ref, ns, na))
        return {"trajs": trajs}


# what the port's `build_policy` reads of a checkpoint's args, and the one
# value of each that the reference holds (a missing key means that value)
HELD = {"deq": True, "policy_variant": "base", "addmem": False, "layer_type": "gcn",
        "qp_solve": True, "lastqp_solve": False, "recompute_Qq": False, "solver_type": "al",
        "compute_dtype": "f32", "dtype": "float32", "obstacle_net_input": False,
        "deq_out_type": 1}


def build_policy(args: Mapping[str, Any], env, device="cuda",
                 dtype=torch.float32) -> DEQMPCPolicy:
    """The policy a checkpoint's `args` describe (`training/train.py:191-246`),
    where they ask for what the reference holds; else NotImplementedError."""
    a = dict(args)
    for key, held in HELD.items():
        if a.get(key, held) != held:
            raise NotImplementedError(f"the reference holds {key}={held!r}, not {a[key]!r}")
    deq_type = a.get("deq_type", "deq")
    fp_type = a.get("fp_type", "anderson")
    if deq_type not in ("deq", "nn") or (deq_type == "deq" and (
            fp_type != "anderson" or a.get("grad_type", "fp_grad") == "implicit")):
        raise NotImplementedError(f"the reference has no deq_type {deq_type!r} with "
                                  f"fp_type {fp_type!r} and grad_type {a.get('grad_type')!r}")
    nq = a["nq"] if a.get("nq", 0) > 0 else (env.nq if env.nq <= env.nx // 2 else env.nx // 2)
    rho_max = a.get("rho_max")
    cfg = PolicyConfig(
        nx=env.nx, nu=env.nu, nq=min(nq, env.nx // 2), T=a["T"], dt=env.dt,
        hdim=a["hdim"], deq_iter=a["deq_iter"], fp_type=fp_type,
        fp_max_steps=int(a.get("max_steps", 10)), fp_m=a.get("m", 5),
        kernel_width=a.get("kernel_width", 3), al_iter=2,
        rho_max=1e5 if rho_max is None else rho_max, deq_type=deq_type)
    return DEQMPCPolicy(cfg, env, device=device, dtype=dtype)
