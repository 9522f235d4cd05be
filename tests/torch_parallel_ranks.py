"""The cases of `tests/test_torch_parallel.py`, run in each process of a
gloo group on the CPU, or in one process without a group.

Imports torch, numpy and the port only. As a script it joins a group of
`--world` processes as `--rank` and writes its results to `--out`
(`torch.save`):

    python tests/torch_parallel_ranks.py --rank 0 --world 2 --port 29500 --out r0.pt

`run_cases()` without a group gives the one-process results the ranks are
held to. The cases are the four of `tests/test_sharding.py` (a training
step, two streaming ticks, the history variant's forward, an obstacle
solve) on the pendulum policy of `tests/test_multihost.py` and JAX's
triple integrator, each process on its slice of the same global batch,
and a Newton solve whose one non-SPD sample lies in the last process's
slice. The networks and their inputs are in f64, so that the one-process
results can be held to JAX's tightly: in f32 the two packages' roundings
of the network differ, and the solves at rho 1e8 magnify that. With `plants`, the same cases again with a fault planted:
`skip_grad_allreduce` (the training step's gradients left local) and
`local_retry` (each process decides its retry on its own slice).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deqmpc_tpu_torch.envs import PendulumEnv  # noqa: E402
from deqmpc_tpu_torch.parallel import (collectives, initialize_multihost,  # noqa: E402
                                       make_mesh, replicate_local, shard_batch)
from deqmpc_tpu_torch.policies import (DEQMPCPolicyHistory, PolicyConfig,  # noqa: E402
                                       compute_loss_deqmpc)
from deqmpc_tpu_torch.solvers import ALMPC, NewtonAL, ObstacleSet, QuadCost  # noqa: E402
from deqmpc_tpu_torch.solvers.types import LinDx  # noqa: E402
from deqmpc_tpu_torch.training import train  # noqa: E402
from deqmpc_tpu_torch import multihost_worker  # noqa: E402

BSZ = 16
HISTORY_H = 3
OBSTACLE_T, RETRY_T, RETRY_N = 6, 5, 4
RETRY_BAD = BSZ - 3  # the non-SPD sample: in the last process's slice


def sharding_batch():
    """`tests/test_sharding.py`'s global batch (the JAX worker's)."""
    return multihost_worker.global_batch(BSZ)


def history_config(env):
    return PolicyConfig(nx=2, nu=1, nq=1, T=4, dt=env.dt, hdim=16, layer_type="mlp",
                        deq_iter=2, fp_max_steps=4, solver_dtype=torch.float64)


def history_obs():
    return np.random.default_rng(3).uniform(-1, 1, (BSZ, HISTORY_H, 2)).astype(np.float32)


def obstacle_problem():
    """`test_sharded_obstacle_solve_matches_single_device`'s solve: x0, Q,
    q, the 40 sphere centres, the radius, the goal."""
    T, nx, nu = OBSTACLE_T, 3, 3
    rng = np.random.default_rng(0)
    x0 = np.concatenate([-np.ones((BSZ, 1)), rng.uniform(-0.2, 0.2, (BSZ, 2))], axis=1)
    goal = np.array([1.0, 0.0, 0.0])
    Q = np.tile(np.array([1.0] * nx + [0.1] * nu), (BSZ, T, 1))
    q = -Q * np.tile(np.concatenate([goal, np.zeros(nu)]), (BSZ, T, 1))
    centers = np.zeros((40, 3))
    centers[1:] = rng.uniform(5, 10, (39, 3))
    return x0, Q, q, centers, 0.3, goal


def retry_system():
    """A seeded SPD block-tridiagonal system (BSZ, RETRY_T, RETRY_N) whose
    sample RETRY_BAD has a negative-definite block."""
    rng = np.random.default_rng(7)
    n, T = RETRY_N, RETRY_T
    A = rng.normal(size=(BSZ, T, n, n))
    D = A @ np.swapaxes(A, -1, -2) + 2.0 * np.eye(n) * (T + 1)
    D[RETRY_BAD, T // 2] = -np.eye(n)
    O = 0.3 * rng.normal(size=(BSZ, T - 1, n, n))
    g = rng.normal(size=(BSZ, T, n))
    return D, O, g


def _loss(policy, batch, coeffs=None):
    """`tests/test_sharding.py`'s loss: the forward with the solve, then
    `compute_loss_deqmpc` without the start states."""
    policy_out = policy.forward(batch["obs"], qp_solve=True)
    return compute_loss_deqmpc(policy, batch["state"], batch["action"], batch["mask"],
                               policy_out)


def pendulum_policy():
    """The worker's policy (seed 0), its network in f64."""
    policy = multihost_worker.build_policy("cpu")
    policy.model.double()
    return policy


def _f64(a):
    return torch.as_tensor(a, dtype=torch.float64)


def case_train_step(mesh):
    policy = pendulum_policy()
    replicate_local(policy.model, mesh)
    opt = train.make_optimizer(policy)
    batch = {k: _f64(v) for k, v in shard_batch(sharding_batch(), mesh).items()}
    res = train.train_step(policy, opt, batch, loss=_loss)
    return {"loss": float(res["loss"]), "grad_norm": float(res["grad_norm"]),
            "grads": {k: p.grad.detach().clone() for k, p in policy.model.named_parameters()
                      if p.grad is not None},
            "new_params": {k: p.detach().clone() for k, p in policy.model.named_parameters()}}


def case_streaming(mesh):
    policy = pendulum_policy()
    obs = _f64(shard_batch(sharding_batch(), mesh)["obs"])
    with torch.inference_mode():
        po = policy.forward(obs, qp_solve=True)
        po2 = policy.forward_warm_start(obs, po["carry"], qp_solve=True)
    return {"x": po2["trajs"][-1][1].clone()}


def case_history(mesh):
    env = PendulumEnv()
    policy = DEQMPCPolicyHistory(history_config(env), env, H=HISTORY_H, device="cpu").init(0)
    policy.model.double()
    obs = _f64(shard_batch(history_obs(), mesh))
    with torch.inference_mode():
        po = policy.forward(obs, qp_solve=True)
    return {"x": po["trajs"][-1][1].clone(),
            "state": {k: v.clone() for k, v in policy.model.state_dict().items()}}


def case_obstacle(mesh):
    x0, Q, q, centers, radius, goal = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                       for a in obstacle_problem())
    x0, Q, q = (shard_batch(a, mesh) for a in (x0, Q, q))
    bsz, T, nx, nu, dt = x0.shape[0], OBSTACLE_T, 3, 3, 0.2
    eye = torch.eye(nx, dtype=torch.float64)
    F = torch.cat([eye, dt * eye], dim=1).expand(bsz, T - 1, nx, nx + nu)
    dyn, dyn_jac = ALMPC.linear_dynamics(LinDx(F=F, f=torch.zeros(bsz, T - 1, nx,
                                                                dtype=torch.float64)))
    ctrl = ALMPC(nx, nu, T, -5 * np.ones(nu), 5 * np.ones(nu), dyn, dyn_jac,
                 dtype=torch.float64, obstacles=ObstacleSet(centers, radius), n_obs_sel=4,
                 device="cpu")
    with torch.inference_mode():
        sel = ctrl.select_obstacles(goal.expand(bsz, T, nx))
        x, _, _, _ = ctrl.solve(x0, QuadCost(Q, q, None), ctrl.init_state(bsz), al_iter=6,
                                obstacles=sel)
    return {"x": x.clone()}


def case_retry(mesh):
    D, O, g = (shard_batch(torch.as_tensor(a), mesh) for a in retry_system())
    newton = multihost_worker.build_policy("cpu").newton_solver
    upd = newton._solve_newton_system(g, D, O)
    return {"update": upd, "retries": newton.retries}


CASES = {"train_step": case_train_step, "streaming": case_streaming, "history": case_history,
         "obstacle": case_obstacle, "retry": case_retry}


def _local_retry(upd) -> bool:
    return bool(torch.isfinite(upd).all())


PLANTS = {"skip_grad_allreduce": ("train_step", collectives, "average_gradients",
                                  lambda params: None),
          "local_retry": ("retry", NewtonAL, "_all_finite", staticmethod(_local_retry))}


def run_cases(plants=()):
    """{case: result} on this process's slice (the whole batch without a
    group), then {"planted:<name>": the plant's case with the fault}."""
    torch.set_num_threads(2)
    mesh = make_mesh(device="cpu")
    out = {name: case(mesh) for name, case in CASES.items()}
    for plant in plants:
        case, owner, attr, fault = PLANTS[plant]
        good = owner.__dict__[attr]
        setattr(owner, attr, fault)
        try:
            out[f"planted:{plant}"] = CASES[case](mesh)
        finally:
            setattr(owner, attr, good)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="one process of the parallel cases")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--plants", default="", help="comma-separated PLANTS")
    a = ap.parse_args(argv)
    initialize_multihost(f"localhost:{a.port}", a.world, a.rank, backend="gloo",
                         timeout_s=300)
    try:
        out = run_cases([p for p in a.plants.split(",") if p])
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, a.out)


if __name__ == "__main__":
    main()
