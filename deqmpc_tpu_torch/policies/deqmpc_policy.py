"""DEQ-MPC policy: the outer network <-> optimizer iteration.

Port of `PolicyConfig`, `DEQMPCPolicy.__init__`, `forward` and
`_deqmpc_iter` (`deqmpc_tpu/policies/deqmpc_policy.py:43-236`) for the
cold-start forward of serving and training: N = deq_iter rounds of
{network proposal -> AL tracking solve}; the solver's trajectory feeds
the next round's network input with its gradient (as in JAX), and the
AL state (duals, penalty, iterate) carries from round to round. The
policy also carries what the loss reads (`deq_reg`, `loss_type`,
`out_type`). `build_policy` mirrors `training/train.py:191-246` for
the base variant. The streaming forward and the other variants wait for
later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import torch

from .. import resolve_device
from ..models.deq_layer import DEQLayer, DEQLayerConfig
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
    fp_max_steps: int = 10
    fp_m: int = 5
    kernel_width: int = 3
    al_iter: int = 2
    solver_dtype: Any = torch.float32
    max_newton_steps: int = 4
    rho_max: float = 1e8
    dyn_res_tol: float = 1e-3
    deq_reg: float = 0.1
    out_type: int = 1        # policy_out_type
    loss_type: str = "l1"


class DEQMPCPolicy:
    def __init__(self, cfg: PolicyConfig, env, device="cuda"):
        self.cfg = cfg
        self.env = env
        self.nx, self.nu, self.nq, self.T = cfg.nx, cfg.nu, cfg.nq, cfg.T
        self.deq_iter = cfg.deq_iter
        self.out_type, self.loss_type, self.deq_reg = cfg.out_type, cfg.loss_type, cfg.deq_reg
        self.device = resolve_device(device)
        mcfg = DEQLayerConfig(
            nx=cfg.nx, nu=cfg.nu, nq=cfg.nq, T=cfg.T, dt=cfg.dt, hdim=cfg.hdim,
            deq_iter=cfg.deq_iter, fp_m=cfg.fp_m, fp_max_steps=cfg.fp_max_steps,
            kernel_width=cfg.kernel_width,
        )
        self.model = DEQLayer(mcfg).to(self.device)
        self.tracking_mpc = TrackingMPC(
            env, cfg.T, al_iter=cfg.al_iter, dtype=cfg.solver_dtype,
            max_newton_steps=cfg.max_newton_steps, rho_max=cfg.rho_max,
            dyn_res_tol=cfg.dyn_res_tol, device=self.device,
        )

    def init(self, seed: int) -> "DEQMPCPolicy":
        """Seeded fresh parameters (`DEQLayer.reset_parameters`: flax's
        distributions, not flax's draws)."""
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        return self

    @property
    def newton_solver(self):
        return self.tracking_mpc.ctrl.newton

    @property
    def newton_steps(self) -> int:
        """Newton steps taken by this policy's solver so far."""
        return self.newton_solver.steps

    @property
    def newton_retries(self) -> int:
        """Jittered re-solves after a non-finite Newton update so far."""
        return self.newton_solver.retries

    @property
    def backward_solves(self) -> int:
        """Implicit-backward solves so far (one per round in training)."""
        return self.newton_solver.backward_solves

    def backward_zeroed_share(self) -> float:
        """Share of the implicit backward's samples whose gradient was set
        to 0 (a non-positive-definite Hessian); reads the device once."""
        n = self.newton_solver
        return float(n.backward_zeroed) / n.backward_samples if n.backward_samples else 0.0

    def forward(self, obs) -> Dict:
        """Cold-start forward (`deqmpc_policy.py:143-161`). obs (bsz, nx)
        -> {"trajs": [(x_ref, x_opt, u_opt)] * deq_iter, "status",
        "init_states"}."""
        bsz = obs.shape[0]
        x_ref = obs[:, None].expand(bsz, self.T, self.nx)
        policy_out = self._deqmpc_iter(obs, x_ref,
                                       self.model.init_z(bsz, obs.dtype, obs.device),
                                       self.tracking_mpc.init_state(bsz))
        policy_out["init_states"] = x_ref
        return policy_out

    def _deqmpc_iter(self, obs, x_prev, z, sol_state) -> Dict:
        trajs = []
        status = torch.zeros((obs.shape[0],), dtype=torch.bool, device=obs.device)
        for _ in range(self.deq_iter):
            out_mpc, z = self.model(obs, x_prev, z)
            x_t, x_ref, u_ref = out_mpc["x_t"], out_mpc["x_ref"], out_mpc["u_ref"]
            ns, na, status, sol_state = self.tracking_mpc(
                x_t, x_ref, u_ref, sol_state, al_iters=self.cfg.al_iter)
            x_prev = ns
            trajs.append((x_ref, ns, na))
        return {"trajs": trajs, "status": status}


def build_policy(args: Mapping[str, Any], env, device="cuda") -> DEQMPCPolicy:
    """The policy a checkpoint's `args` describe (`training/train.py:191-246`,
    base deq-mpc variant only)."""
    a = dict(args)
    unsupported = {
        "deq": (True,), "qp_solve": (True,), "lastqp_solve": (False,),
        "solver_type": ("al",), "policy_variant": ("base",), "addmem": (False,),
        "streaming": (False,), "deq_type": ("deq",), "layer_type": ("gcn",),
        "fp_type": ("anderson",), "deq_out_type": (1,), "grad_type": ("fp_grad",),
        "recompute_Qq": (False,), "compute_dtype": ("f32",),
    }
    for key, ok in unsupported.items():
        if key in a and a[key] not in ok:
            raise NotImplementedError(f"{key}={a[key]!r} is not ported yet")
    nq = a["nq"] if a.get("nq", 0) > 0 else (env.nq if env.nq <= env.nx // 2 else env.nx // 2)
    double = a.get("dtype", "float32") == "double"
    rho_max = a.get("rho_max")
    if rho_max is None:
        rho_max = 1e8 if double else 1e5
    cfg = PolicyConfig(
        nx=env.nx, nu=env.nu, nq=min(nq, env.nx // 2), T=a["T"], dt=env.dt,
        hdim=a["hdim"], deq_iter=a["deq_iter"],
        fp_max_steps=int(a.get("max_steps", 10)), fp_m=a.get("m", 5),
        kernel_width=a.get("kernel_width", 3), al_iter=2,
        solver_dtype=torch.float64 if double else torch.float32, rho_max=rho_max,
        deq_reg=a.get("deq_reg", 0.1), out_type=a.get("policy_out_type", 1),
        loss_type=a.get("loss_type", "l1"),
    )
    return DEQMPCPolicy(cfg, env, device=device)
