"""DEQ-MPC policy: the outer network <-> optimizer iteration.

Port of `PolicyCarry`, `PolicyConfig`, `DEQMPCPolicy.__init__`,
`forward`, `forward_warm_start`, `_deqmpc_iter` and `_save_carry`
(`deqmpc_tpu/policies/deqmpc_policy.py:33-264`): N = deq_iter rounds of
{network proposal -> AL tracking solve}; the solver's trajectory feeds
the next round's network input with its gradient (as in JAX), and the
AL state (duals, penalty, iterate) carries from round to round. The
policy also carries what the loss reads (`deq_reg`, `loss_type`,
`out_type`).

Streaming (receding horizon): every forward returns its carry in
`policy_out["carry"]`, the last round's latent z, trajectory and AL state
shifted one knot and detached (JAX's `lax.stop_gradient`), so a warm
tick never backpropagates into the tick before it. `forward_warm_start`
starts from a carry: after round 0's network call the AL state is shifted
once more (`warm_start_shift`, rho clamped to `rho_warm_max`), and every
tracking solve takes the streaming exit (and, with `linearize_once`, the
linear model). With `deq_type="nn"` (deq-mpc-nn) the network is the
feed-forward `FFDNetwork`; with an obstacle field and
`obstacle_constraints` (the default) every tracking solve carries the
rows of the spheres nearest to its reference.

The loop's two switches (`deqmpc_policy.py:176-236`), defaulting to the
config's `qp_solve` and `lastqp_solve`: without `qp_solve` a round makes
no solve and records (x_ref, x_ref, u_ref), and the next round reads the
network's own trajectory. With `lastqp_solve` every round's solver half
is detached, and after the last round one more tracking solve of 10 AL
iterations (cold, from the last round's reference and the carried AL
state) replaces the last record and sets `status`; the carry keeps that
solve's AL state. The model types of the train CLI set them: diff-mpc
(`qp_solve` off, `lastqp_solve` on, one round), deq (neither, one round).
`NNMPCPolicy` is the feed-forward network, one round (the nn model type).
`solver_type="ip"` puts the interior-point SQP solve in every tracking
solve. `build_policy` mirrors `training/train.py:191-246`: the base
policy, `NNMPCPolicy`, and the variants of `policies/policy_variants.py`
(`policy_variant` mem (or `addmem`), delta, history, estpred, feedback,
q), each model made by the class's `_make_model` hook. The network's
round is `model.step(obs, aux)`: `aux` holds the carried trajectory, the
latent z and `iter` (round i, or i + 2 on warm ticks, `deqmpc_policy.py:183`;
only the variants with iteration embeddings read it) and a variant's own
streams. `layer_type="mlp"` is the flat trunk; `obstacle_net_input` with a
field gives the network the nearest-sphere features of every knot.

The fixed point and the trunk (`deqmpc_policy.py:56-85`): `fp_type`,
`grad_type`, `fp_m`, `fp_max_steps` and `compute_dtype` go to the network
(`models/deq_layer.py`); as in JAX, the config has no `inner_deq_iters`, so
`fp_type` multi applies the cell the layer's default 4 times. Each round's solver stats land
in `policy_out["deq_stats"]`, {"fwd_err", "fwd_steps"} stacked over the
rounds, when the network runs a solver (`deqmpc_policy.py:220-235`).
`recompute_Qq` (`deqmpc_policy.py:194-207`): every tracking solve refreshes
its cost between AL iterations from `model_call`, the round's network run
under `torch.no_grad()` on the solver's iterate (cast to the observation's
dtype) with the round's aux and `iter`; the aux that call returns is
discarded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch

from .. import resolve_device
from ..models.deq_layer import DEQLayer, DEQLayerConfig, FFDNetwork
from ..solvers import ALState, ObstacleSet
from ..utils import profiling
from .tracking_mpc import TrackingMPC


class PolicyCarry(NamedTuple):
    """Streaming carry: the latent z ((bsz, T-1, hdim) for the gcn trunk,
    (bsz, hdim) for the mlp one), trajectory x (bsz, T, nx) and u
    (bsz, T, nu), and the AL solver state."""

    z: torch.Tensor
    x: torch.Tensor
    u: torch.Tensor
    solver: ALState


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    nx: int
    nu: int
    nq: int
    T: int
    dt: float
    hdim: int = 128
    layer_type: str = "gcn"  # or "mlp"
    deq_iter: int = 6
    deq_out_type: int = 1    # 2: the History variant's joint state and action output
    fp_type: str = "anderson"  # "single" | "multi" | "broyden" | "anderson"
    fp_max_steps: int = 10
    fp_m: int = 5
    grad_type: str = "fp_grad"
    compute_dtype: Any = None  # the trunk's matmul dtype: None or torch.bfloat16
    # the cost refresh between AL iterations from the network
    recompute_Qq: bool = False
    kernel_width: int = 3
    al_iter: int = 2
    solver_dtype: Any = torch.float32
    max_newton_steps: int = 4
    rho_max: float = 1e8
    rho_init_max: float = 1e4
    dyn_res_tol: float = 1e-3
    # streaming ticks freeze the dynamics Jacobians once per solve
    linearize_once: bool = False
    deq_reg: float = 0.1
    out_type: int = 1        # policy_out_type
    loss_type: str = "l1"
    deq_type: str = "deq"    # or "nn": the feed-forward FFDNetwork
    # gates the solver's obstacle rows when the policy is given a field
    obstacle_constraints: bool = True
    # the loop's switches, the defaults of `forward` and `forward_warm_start`
    qp_solve: bool = True
    lastqp_solve: bool = False
    solver_type: str = "al"  # or "ip": the interior-point SQP solve
    qp_iter: int = 1
    ip_eps: float = 1e-2
    ip_grad_method: str = "analytic"
    # the network's nearest-sphere input, when the policy is given a field
    obstacle_net_input: bool = False


class DEQMPCPolicy:
    takes_history = False         # forward reads an (bsz, H, nx) history
    takes_action_history = False  # forward also reads the history's actions
    is_delta = False              # the trainer's EMA of the output scales

    def __init__(self, cfg: PolicyConfig, env, device="cuda",
                 obstacles: Optional[ObstacleSet] = None):
        self.cfg = cfg
        self.env = env
        self.nx, self.nu, self.nq, self.T = cfg.nx, cfg.nu, cfg.nq, cfg.T
        self.deq_iter = cfg.deq_iter
        self.out_type, self.loss_type, self.deq_reg = cfg.out_type, cfg.loss_type, cfg.deq_reg
        self.device = resolve_device(device)
        # The warm restart's penalty keeps the depth of the rho schedule,
        # not the constant: JAX measured 0% success warm-started with
        # rho_init_max 1e4 under the f32 rho_max 1e5, 100% with 10
        # (`deqmpc_policy.py:118-126`)
        self.rho_warm_max = min(cfg.rho_init_max, cfg.rho_max * 1e-4)
        aware = cfg.obstacle_net_input and obstacles is not None
        mcfg = DEQLayerConfig(
            nx=cfg.nx, nu=cfg.nu, nq=cfg.nq, T=cfg.T, dt=cfg.dt, hdim=cfg.hdim,
            layer_type=cfg.layer_type, deq_iter=cfg.deq_iter, fp_type=cfg.fp_type,
            fp_m=cfg.fp_m, fp_max_steps=cfg.fp_max_steps, kernel_width=cfg.kernel_width,
            grad_type=cfg.grad_type,
            compute_dtype=cfg.compute_dtype,
            obstacle_centers=torch.as_tensor(obstacles.centers).cpu().numpy() if aware else None,
            obstacle_radius=float(obstacles.radius) if aware else 0.0,
        )
        model = FFDNetwork(mcfg) if cfg.deq_type == "nn" else self._make_model(mcfg)
        self.model = model.to(self.device)
        self.tracking_mpc = TrackingMPC(
            env, cfg.T, al_iter=cfg.al_iter, dtype=cfg.solver_dtype,
            max_newton_steps=cfg.max_newton_steps, rho_max=cfg.rho_max,
            dyn_res_tol=cfg.dyn_res_tol,
            obstacles=obstacles if cfg.obstacle_constraints else None,
            solver_type=cfg.solver_type, qp_iter=cfg.qp_iter, ip_eps=cfg.ip_eps,
            ip_grad_method=cfg.ip_grad_method, device=self.device,
        )

    def _make_model(self, mcfg: DEQLayerConfig):
        """The network of this policy class (`deqmpc_policy.py:131-132`)."""
        return DEQLayer(mcfg)

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

    def _mode(self, qp_solve, lastqp_solve):
        cfg = self.cfg
        return (cfg.qp_solve if qp_solve is None else qp_solve,
                cfg.lastqp_solve if lastqp_solve is None else lastqp_solve)

    def _cold_aux(self, x_t) -> Dict:
        """The first round's aux: the current state tiled over the horizon,
        zero actions, a zero latent."""
        bsz = x_t.shape[0]
        return {"x": x_t[:, None].expand(bsz, self.T, self.nx),
                "u": torch.zeros((bsz, self.T, self.nu), dtype=x_t.dtype, device=x_t.device),
                "z": self.model.init_z(bsz, x_t.dtype, x_t.device)}

    def forward(self, obs, qp_solve: Optional[bool] = None,
                lastqp_solve: Optional[bool] = None) -> Dict:
        """Cold-start forward (`deqmpc_policy.py:143-160`). obs (bsz, nx)
        -> {"trajs": [(x_ref, x_opt, u_opt)] * deq_iter, "status",
        "init_states", "carry"}."""
        with profiling.span("policy.forward"):
            aux = self._cold_aux(obs)
            policy_out = self._deqmpc_iter(obs, aux, self.tracking_mpc.init_state(obs.shape[0]),
                                           *self._mode(qp_solve, lastqp_solve))
            policy_out["init_states"] = aux["x"]
            return policy_out

    def forward_warm_start(self, obs, carry: PolicyCarry, qp_solve: Optional[bool] = None,
                           lastqp_solve: Optional[bool] = None) -> Dict:
        """Streaming forward (`deqmpc_policy.py:163-173`) from the carry of
        the tick before; same outputs as `forward`."""
        with profiling.span("policy.forward"):
            aux = {"x": carry.x, "u": carry.u, "z": carry.z}
            policy_out = self._deqmpc_iter(obs, aux, carry.solver,
                                           *self._mode(qp_solve, lastqp_solve), warm_start=True)
            policy_out["init_states"] = carry.x
            return policy_out

    def _deqmpc_iter(self, obs, aux: Dict, sol_state, qp_solve: bool,
                     lastqp_solve: bool, warm_start: bool = False) -> Dict:
        cfg = self.cfg
        trajs, stats = [], []
        status = torch.zeros((obs.shape[0],), dtype=torch.bool, device=obs.device)
        for i in range(self.deq_iter):
            it = i + 2 if warm_start else i
            with profiling.span("network.step"):
                out_mpc, aux = self.model.step(obs, {**aux, "iter": it})
            x_t, x_ref, u_ref = out_mpc["x_t"], out_mpc["x_ref"], out_mpc["u_ref"]
            if warm_start and i == 0:
                # the receding-horizon shift of the duals and iterate
                sol_state = self.tracking_mpc.warm_start_state(sol_state, self.rho_warm_max)
            ns, na = x_ref, u_ref
            if qp_solve:
                ns, na, status, sol_state = self.tracking_mpc(
                    x_t, x_ref, u_ref, sol_state, al_iters=cfg.al_iter, streaming=warm_start,
                    linearize_once=warm_start and cfg.linearize_once,
                    model_call=self._model_call(obs, aux, it) if cfg.recompute_Qq else None)
                # the next round reads the solver's trajectory
                aux = {**aux, "x": ns, "u": na}
            trajs.append((x_ref, ns.detach(), na.detach()) if lastqp_solve else (x_ref, ns, na))
            stats.append(aux)
        if lastqp_solve:
            ns, na, status, sol_state = self.tracking_mpc(x_t, x_ref, u_ref, sol_state,
                                                          al_iters=10)
            trajs[-1] = (x_ref, ns, na)
        return {"trajs": trajs, "status": status, "carry": self._save_carry(aux, sol_state),
                **deq_stats(stats)}

    def _model_call(self, obs, aux: Dict, it: int):
        """The cost refresh's network call (`deqmpc_policy.py:194-207`):
        xu -> the round's network output (x_ref, u_ref) concatenated, from
        the solver's detached iterate in the observation's dtype, with the
        round's aux and iter, under no_grad."""
        def model_call(xu):
            with torch.no_grad():
                xu = xu.detach().to(obs.dtype)
                out, _ = self.model.step(obs, {**aux, "x": xu[..., : self.nx],
                                               "u": xu[..., self.nx:], "iter": it})
                return torch.cat([out["x_ref"], out["u_ref"]], dim=-1)
        return model_call

    def _save_carry(self, aux: Dict, sol_state) -> PolicyCarry:
        """Shift x and u left one knot, repeating the last, and detach them
        (`deqmpc_policy.py:238-264`); z likewise where a leaf has a time
        axis: 3-D with T or T-1 knots (the mlp latent (bsz, hdim) and a
        history's (bsz, H, hdim) stay as they are)."""
        def shift(a):
            return torch.cat([a[:, 1:], a[:, -1:]], dim=1).detach()

        def shift_z(a):
            return shift(a) if a.dim() == 3 and a.shape[1] in (self.T, self.T - 1) else a.detach()

        z = aux["z"]
        z = tuple(shift_z(a) for a in z) if isinstance(z, tuple) else shift_z(z)
        return PolicyCarry(z=z, x=shift(aux["x"]), u=shift(aux["u"]), solver=sol_state)


def f32_observation(policy, x: torch.Tensor) -> torch.Tensor:
    """The state rounded to f32, as JAX's closed loops cast it before the
    forward (`x.astype(jnp.float32)`), in the dtype of the policy's
    parameters (f32, or f64 where a test runs the network in f64)."""
    return x.float().to(next(policy.model.parameters()).dtype)


def deq_stats(auxes) -> Dict:
    """{"deq_stats": {"fwd_err", "fwd_steps"}}, each stacked over the rounds,
    when the rounds' network ran a solver, else {}."""
    if not auxes or auxes[0].get("deq_fwd_err") is None:
        return {}
    return {"deq_stats": {k: torch.stack([a[f"deq_{k}"] for a in auxes])
                          for k in ("fwd_err", "fwd_steps")}}


class NNMPCPolicy(DEQMPCPolicy):
    """The feed-forward network, one round, with the loop's switches as
    given (`deqmpc_policy.py:267-273`)."""

    def __init__(self, cfg: PolicyConfig, env, device="cuda",
                 obstacles: Optional[ObstacleSet] = None):
        super().__init__(dataclasses.replace(cfg, deq_type="nn", deq_iter=1), env,
                         device=device, obstacles=obstacles)


# the keys the port refuses other values of: deq_type's two are every value the
# JAX CLI takes
NOT_PORTED = {"deq_type": ("deq", "nn")}
POLICY_VARIANTS = ("base", "mem", "delta", "history", "estpred", "feedback", "q")


def build_policy(args: Mapping[str, Any], env, device="cuda",
                 obstacles: Optional[ObstacleSet] = None) -> DEQMPCPolicy:
    """The policy a checkpoint's `args` describe (`training/train.py:191-246`):
    `NNMPCPolicy` when `deq` is false, else the `policy_variant` (`addmem`
    meaning mem; history and estpred with the args' `H`), with the args'
    trunk (`layer_type`, `compute_dtype` "f32" or "bf16"), fixed point
    (`fp_type`, `grad_type`, `m`, `max_steps`),
    `deq_out_type`, `qp_solve`, `lastqp_solve`, `recompute_Qq`,
    `solver_type` and `obstacle_net_input`. `obstacles`: the env's field
    (`training.train.build_obstacles`), or None. A `deq_type` other than
    deq and nn raises NotImplementedError. `inner_deq_iters` is not read:
    the JAX CLI takes the flag and never hands it on, so multi applies the
    cell 4 times whatever it says (ROADMAP C6)."""
    a = dict(args)
    for key, ok in NOT_PORTED.items():
        if key in a and a[key] not in ok:
            raise NotImplementedError(f"{key}={a[key]!r} is not ported")
    variant = "mem" if a.get("addmem", False) else a.get("policy_variant", "base")
    if variant not in POLICY_VARIANTS:
        raise ValueError(f"unknown policy_variant {variant!r}")
    nq = a["nq"] if a.get("nq", 0) > 0 else (env.nq if env.nq <= env.nx // 2 else env.nx // 2)
    double = a.get("dtype", "float32") == "double"
    rho_max = a.get("rho_max")
    if rho_max is None:
        rho_max = 1e8 if double else 1e5
    cfg = PolicyConfig(
        nx=env.nx, nu=env.nu, nq=min(nq, env.nx // 2), T=a["T"], dt=env.dt,
        hdim=a["hdim"], layer_type=a.get("layer_type", "gcn"), deq_iter=a["deq_iter"],
        deq_out_type=a.get("deq_out_type", 1), fp_type=a.get("fp_type", "anderson"),
        fp_max_steps=int(a.get("max_steps", 10)), fp_m=a.get("m", 5),
        kernel_width=a.get("kernel_width", 3), al_iter=2,
        solver_dtype=torch.float64 if double else torch.float32, rho_max=rho_max,
        rho_init_max=a.get("rho_init_max", 1e4), linearize_once=a.get("linearize_once", False),
        deq_reg=a.get("deq_reg", 0.1), out_type=a.get("policy_out_type", 1),
        loss_type=a.get("loss_type", "l1"), deq_type=a.get("deq_type", "deq"),
        # a missing key means true, as the JAX CLI's getattr default
        obstacle_constraints=a.get("obstacle_constraints", True),
        qp_solve=a.get("qp_solve", True), lastqp_solve=a.get("lastqp_solve", False),
        solver_type=a.get("solver_type", "al"), qp_iter=a.get("qp_iter", 1),
        ip_eps=a.get("eps", 1e-2), ip_grad_method=a.get("ip_grad_method", "analytic"),
        obstacle_net_input=a.get("obstacle_net_input", False),
        grad_type=a.get("grad_type", "fp_grad"),
        recompute_Qq=a.get("recompute_Qq", False),
        compute_dtype=torch.bfloat16 if a.get("compute_dtype", "f32") == "bf16" else None,
    )
    kw = dict(device=device, obstacles=obstacles)
    if not a.get("deq", True):
        return NNMPCPolicy(cfg, env, **kw)
    if variant == "base":
        return DEQMPCPolicy(cfg, env, **kw)
    from . import policy_variants as pv

    if variant in ("history", "estpred"):
        cls = pv.DEQMPCPolicyHistory if variant == "history" else pv.DEQMPCPolicyHistoryEstPred
        return cls(cfg, env, H=a.get("H", 1), **kw)
    cls = {"mem": pv.DEQMPCPolicyMem, "delta": pv.DEQMPCPolicyDelta,
           "feedback": pv.DEQMPCPolicyFeedback, "q": pv.DEQMPCPolicyQ}[variant]
    return cls(cfg, env, **kw)
