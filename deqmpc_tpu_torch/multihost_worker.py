"""One process of a data-parallel training step over `torch.distributed`.

Port of `scripts/multihost_worker.py`. N processes (this module, one per
device) join one process group through a TCP rendezvous, build the same
pendulum policy from the same seed (hdim 16, T 4, deq_iter 2, the solver
in f64), feed only their own slice of one seeded global batch, and take
one Adam step: the loss, its backward, the gradients averaged over the
processes, Adam (as JAX's worker: no clipping). The solver's batch-global
decisions read the whole batch (`parallel.collectives`), so every process
computes what one process computes on the whole batch.

Each process writes {loss, grad_norm, new_param_norm} (and its rank and
the process count) to `--out`. On the CPU, over gloo:

    python -m deqmpc_tpu_torch.multihost_worker --process_id 0 --num_processes 2 \\
        --coordinator localhost:29500 --out p0.json --device cpu --backend gloo &
    python -m deqmpc_tpu_torch.multihost_worker --process_id 1 --num_processes 2 \\
        --coordinator localhost:29500 --out p1.json --device cpu --backend gloo

On GPUs, one process per card, over nccl (`--device cuda --backend nccl`;
process i drives card i modulo the host's count). Two processes on one
card need gloo: nccl refuses two ranks on one GPU.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from .envs import PendulumEnv
from .parallel import (collectives, initialize_multihost, make_mesh, replicate_local,
                       shard_batch, shard_batch_local)
from .policies import DEQMPCPolicy, PolicyConfig, compute_loss_deqmpc
from .training.train import global_norm


def build_policy(device) -> DEQMPCPolicy:
    """The worker's policy: the JAX worker's configuration, seed 0."""
    env = PendulumEnv()
    cfg = PolicyConfig(nx=2, nu=1, nq=1, T=4, dt=env.dt, hdim=16, layer_type="gcn",
                       deq_iter=2, fp_max_steps=5, solver_dtype=torch.float64)
    return DEQMPCPolicy(cfg, env, device=device).init(0)


def global_batch(bsz: int) -> Dict[str, np.ndarray]:
    """The seeded global batch of the JAX worker."""
    rng = np.random.default_rng(0)
    return {"obs": rng.uniform(-1, 1, (bsz, 2)).astype(np.float32),
            "state": rng.normal(size=(bsz, 4, 2)).astype(np.float32),
            "action": rng.normal(size=(bsz, 4, 1)).astype(np.float32),
            "mask": np.ones((bsz, 4), np.float32)}


def adam_step(policy: DEQMPCPolicy, optimizer: torch.optim.Optimizer,
              batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The loss of this process's shard, its backward, the gradients
    averaged over the processes, one Adam step. Returns the whole batch's
    loss, the gradient's global norm and the new parameters' global norm."""
    params: List[torch.nn.Parameter] = list(policy.model.parameters())
    optimizer.zero_grad(set_to_none=True)
    policy_out = policy.forward(batch["obs"], qp_solve=True)
    loss = compute_loss_deqmpc(policy, batch["state"], batch["action"], batch["mask"],
                               policy_out)["loss"]
    loss.backward()
    collectives.average_gradients(params)
    gnorm = global_norm([p.grad for p in params if p.grad is not None])
    optimizer.step()
    loss = collectives.average_scalars({"loss": loss.detach()})["loss"]
    with torch.no_grad():
        new_norm = global_norm([p.detach() for p in params])
    return {"loss": float(loss), "grad_norm": float(gnorm), "new_param_norm": float(new_norm)}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--coordinator", type=str, required=True, help="host:port of process 0")
    ap.add_argument("--devices_per_host", type=int, default=1,
                    help="1: a torch process drives one device")
    ap.add_argument("--global_bsz", type=int, default=16)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="default: nccl on cuda, gloo on the CPU")
    ap.add_argument("--timeout_s", type=float, default=120.0,
                    help="the process group's init and collective timeout")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    if args.devices_per_host != 1:
        raise SystemExit("a torch process drives one device: --devices_per_host 1")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda, but torch.cuda.is_available() is False")
        device = torch.device("cuda", args.process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    world = initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                 backend=backend, timeout_s=args.timeout_s)
    try:
        if world != args.num_processes:
            raise SystemExit(f"joined {world} processes, expected {args.num_processes}")
        mesh = make_mesh(device=device)
        policy = build_policy(device)
        # the same seed on every process: identical copies, checked
        replicate_local(policy.model, mesh)
        local = shard_batch_local(shard_batch(global_batch(args.global_bsz), mesh), mesh,
                                  global_bsz=args.global_bsz)
        batch = {k: torch.as_tensor(v, device=device) for k, v in local.items()}
        optimizer = torch.optim.Adam(policy.model.parameters(), lr=1e-3)
        out = {"process_id": args.process_id, "process_count": world,
               "global_devices": world * args.devices_per_host,
               **adam_step(policy, optimizer, batch)}
    finally:
        if collectives.active():
            torch.distributed.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
