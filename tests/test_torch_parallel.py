"""Data parallelism over processes (`deqmpc_tpu_torch/parallel`): two gloo
processes on the CPU against one process and against JAX's single device.

The four cases of `tests/test_sharding.py` (a training step, two streaming
ticks, the history variant's forward, the obstacle solve) and a Newton
solve with one non-SPD sample run in two processes of one gloo group
(`tests/torch_parallel_ranks.py`), each on its slice of the same global
batch of 16. The port's batch-global decisions (the Newton exit, the
retry, the line search's mean step, the rho-cap exit) and the gradient
read the whole batch through the group, so:

- the ranks' slices, put together, are the one-process result within
  PARALLEL_TOL (the sums of the global reductions add in another order);
- the ranks agree exactly on the loss, the gradient norm, every averaged
  gradient and the new parameters;
- the one-process result is JAX's within JAX's own sharding tolerances
  (loss 2e-5, gradient norm 2e-4 relative; every gradient within 2e-4 of
  its largest entry; the forwards rtol 1e-5 atol 1e-6; the obstacle solve
  rtol 1e-6 atol 1e-8), with the networks in f64 in both packages (in f32
  their roundings differ, and the solves at rho 1e8 magnify that); the
  streaming and history forwards against JAX are slow (JAX compiles them
  for 10-15 s each);
- a step with the gradient all-reduce skipped, and a retry decided on each
  rank's own slice, are planted faults these checks must catch.

`deqmpc_tpu_torch.multihost_worker` in two processes agrees across its
ranks exactly and is JAX's single-process step within rtol 2e-5 (loss) and
2e-4 (gradient norm), as `tests/test_multihost.py` holds JAX.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.envs import PendulumEnv as JaxPendulum  # noqa: E402
from deqmpc_tpu.policies import DEQMPCPolicy as JaxPolicy  # noqa: E402
from deqmpc_tpu.policies import PolicyConfig as JaxPolicyConfig  # noqa: E402
from deqmpc_tpu.policies import compute_loss_deqmpc as jax_loss  # noqa: E402
from deqmpc_tpu.policies.policy_variants import DEQMPCPolicyHistory as JaxHistory  # noqa: E402
from deqmpc_tpu.solvers import ALMPC as JaxALMPC  # noqa: E402
from deqmpc_tpu.solvers import ObstacleSet as JaxObstacleSet  # noqa: E402
from deqmpc_tpu.solvers import QuadCost as JaxQuadCost  # noqa: E402
from deqmpc_tpu.solvers.al_core import lin_dyn_fns  # noqa: E402
from deqmpc_tpu.solvers.types import LinDx as JaxLinDx  # noqa: E402
from deqmpc_tpu_torch import multihost_worker  # noqa: E402
from deqmpc_tpu_torch.parallel import (Mesh, collectives, make_mesh, replicate,  # noqa: E402
                                       replicate_local, shard_batch, shard_batch_local)
from deqmpc_tpu_torch.training.train import MAX_GRAD_NORM  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from test_torch_diffmpc import _jax_params_from_port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
PLANTS = ("skip_grad_allreduce", "local_retry")
# two processes against one: the same per-sample arithmetic; the global
# sums (residual norms, the mean step) add in another order
PARALLEL_TOL = dict(rtol=1e-9, atol=1e-12)
# JAX's own sharding and multi-host tolerances (`tests/test_sharding.py`,
# `tests/test_multihost.py`)
JAX_LOSS_RTOL, JAX_GNORM_RTOL, JAX_GRAD_RTOL = 2e-5, 2e-4, 2e-4
JAX_FWD_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_OBSTACLE_TOL = dict(rtol=1e-6, atol=1e-8)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(cmds, tmp_path):
    """Start the commands at once, one process each: [(process, log path)]."""
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop("PYTHONPATH", None)
    procs = []
    for i, cmd in enumerate(cmds):
        log = tmp_path / f"proc{i}.log"
        with open(log, "w") as f:
            procs.append((subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env,
                                           cwd=REPO), log))
    return procs


def _kill(procs):
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _wait(procs, timeout=600):
    """Wait for the processes; fail with a failed one's log. Kill what is
    left on the way out."""
    try:
        for i, (p, log) in enumerate(procs):
            rc = p.wait(timeout=timeout)
            assert rc == 0, f"process {i} failed (rc={rc}):\n{log.read_text()[-3000:]}"
    finally:
        _kill(procs)


@pytest.fixture(scope="module")
def rank_procs(tmp_path_factory):
    """The two rank processes, started first: they run while this process
    computes its own references."""
    tmp = tmp_path_factory.mktemp("ranks")
    port = _free_port()
    script = os.path.join(REPO, "tests", "torch_parallel_ranks.py")
    procs = _start([[sys.executable, script, "--rank", str(r), "--world", str(WORLD), "--port",
                     str(port), "--out", str(tmp / f"r{r}.pt"), "--plants", ",".join(PLANTS)]
                    for r in range(WORLD)], tmp)
    yield procs, tmp
    _kill(procs)


@pytest.fixture(scope="module")
def two_ranks(rank_procs, one_process, jax_step_f64):
    """Each rank's results, in rank order."""
    procs, tmp = rank_procs
    _wait(procs)
    return [torch.load(tmp / f"r{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_process():
    return ranks.run_cases(PLANTS)


def _cat(results, case, key):
    return torch.cat([r[case][key] for r in results])


def _pendulum_jax(policy_cls=JaxPolicy, **kw):
    env = JaxPendulum()
    cfg = JaxPolicyConfig(nx=2, nu=1, nq=1, T=4, dt=env.dt, bsz=ranks.BSZ, hdim=16,
                          layer_type=kw.pop("layer_type", "gcn"), deq_iter=2,
                          fp_max_steps=kw.pop("fp_max_steps", 5), solver_dtype=jnp.float64)
    return policy_cls(cfg, env, **kw)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's single-device loss and gradient of the training step (and of
    the multi-host worker's step: the same weights, batch and loss), on the
    port's seed-0 weights."""
    jpol = _pendulum_jax()
    state = multihost_worker.build_policy("cpu").model.state_dict()
    params = _jax_params_from_port(jpol.init(jax.random.PRNGKey(0)), state)
    batch = {k: jnp.asarray(v) for k, v in ranks.sharding_batch().items()}
    return _jax_loss_and_grads(jpol, params, batch)


@pytest.fixture(scope="module")
def jax_step_f64():
    """The same in f64 (the weights, the network and the batch): the
    training-step case's reference."""
    jpol = _pendulum_jax()
    state = ranks.pendulum_policy().model.state_dict()
    params = _jax_params_from_port(jpol.init(jax.random.PRNGKey(0)), state)
    batch = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in ranks.sharding_batch().items()}
    return _jax_loss_and_grads(jpol, params, batch)


def _jax_loss_and_grads(jpol, params, batch):
    """(loss, the gradient's global norm, the gradients by the port's names)."""
    def loss_fn(p, b):
        policy_out, _ = jpol.forward(p, b["obs"], qp_solve=True)
        return jax_loss(jpol, b["state"], b["action"], b["mask"], policy_out)["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path if k == "params" else path + [k])
            return
        if len(path) >= 2 and path[-2].startswith("Dense_") and path[-1] == "kernel":
            flat[".".join(path[:-1] + ["weight"])] = np.asarray(node).T
        else:
            flat[".".join(path)] = np.asarray(node)

    walk(grads, [])
    gnorm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in flat.values())))
    return float(loss), gnorm, flat


def _rel(a, b):
    """The largest entry of |a - b| over the largest of |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _step_gaps(step, ref):
    """(loss, gradient norm, the worst gradient) gaps of a step to `ref`."""
    return (abs(step["loss"] - ref["loss"]) / abs(ref["loss"]),
            abs(step["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
            max(_rel(step["grads"][k], g) for k, g in ref["grads"].items()))


def test_one_process_helpers_are_the_identity():
    """Without a group the mesh is one process and every helper returns
    what it was given; the reductions are the plain ones."""
    mesh = make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    batch = ranks.sharding_batch()
    assert shard_batch(batch, mesh) is batch
    assert shard_batch_local(batch, mesh, global_bsz=ranks.BSZ) is batch
    tree = {"w": torch.arange(3.0)}
    assert replicate(tree, mesh) is tree and replicate_local(tree, mesh) is tree
    t = torch.randn(5, 3, dtype=torch.float64)
    assert torch.equal(collectives.global_norm(t), torch.linalg.vector_norm(t))
    assert torch.equal(collectives.batch_mean(t[:, 0]), torch.mean(t[:, 0]))
    assert collectives.gather_batch(t) is t
    with pytest.raises(ValueError, match="2 processes"):
        make_mesh(2)


def test_shard_batch_refuses_an_uneven_batch_and_a_wrong_local_shard():
    mesh = Mesh(group=None, world_size=3, rank=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split over 3"):
        shard_batch({"obs": np.zeros((16, 2))}, mesh)
    part = shard_batch({"obs": np.arange(12.0)}, mesh)
    np.testing.assert_array_equal(part["obs"], np.arange(4.0, 8.0))
    with pytest.raises(ValueError, match="global batch of 16"):
        shard_batch_local({"obs": np.zeros((6, 2))}, mesh, global_bsz=16)
    with pytest.raises(ValueError, match="disagree"):
        shard_batch_local({"a": np.zeros(4), "b": np.zeros(5)}, mesh)


def test_two_process_train_step_matches_one_process_and_jax(two_ranks, one_process,
                                                            jax_step_f64):
    one = one_process["train_step"]
    r0, r1 = (r["train_step"] for r in two_ranks)
    # the ranks: the same scalars, gradients and new parameters, bit for bit
    assert (r0["loss"], r0["grad_norm"]) == (r1["loss"], r1["grad_norm"])
    for k in r0["grads"]:
        assert torch.equal(r0["grads"][k], r1["grads"][k]), k
        assert torch.equal(r0["new_params"][k], r1["new_params"][k]), k
    gaps = _step_gaps(r0, one)
    print(f"two ranks vs one process (loss, grad norm, worst gradient): {gaps}")
    assert max(gaps) <= PARALLEL_TOL["rtol"]
    # the one-process step is JAX's (the gradients as JAX's, clipped as the step clips)
    loss, gnorm, grads = jax_step_f64
    clip = min(1.0, MAX_GRAD_NORM / gnorm)
    jax_gaps = _step_gaps(one, {"loss": loss, "grad_norm": gnorm,
                                "grads": {k: g * clip for k, g in grads.items()
                                          if k in one["grads"]}})
    print(f"one process vs JAX: {jax_gaps}")
    assert jax_gaps[0] <= JAX_LOSS_RTOL and jax_gaps[1] <= JAX_GNORM_RTOL
    assert jax_gaps[2] <= JAX_GRAD_RTOL


def test_skipped_gradient_all_reduce_is_caught(two_ranks, one_process):
    """The planted fault: each rank steps on its own slice's gradient."""
    one = one_process["train_step"]
    r0, r1 = (r["planted:skip_grad_allreduce"] for r in two_ranks)
    assert max(_step_gaps(r0, one)) > PARALLEL_TOL["rtol"]
    assert not all(torch.equal(r0["new_params"][k], r1["new_params"][k]) for k in r0["grads"])


@pytest.mark.parametrize("case", ["streaming", "history", "obstacle"])
def test_two_process_forward_matches_one_process(two_ranks, one_process, case):
    torch.testing.assert_close(_cat(two_ranks, case, "x"), one_process[case]["x"],
                               **PARALLEL_TOL)


@pytest.mark.slow
def test_one_process_streaming_ticks_match_jax(one_process):
    jpol = _pendulum_jax()
    params = _jax_params_from_port(jpol.init(jax.random.PRNGKey(0)),
                                   ranks.pendulum_policy().model.state_dict())

    def two_ticks(p, o):
        po, carry = jpol.forward(p, o, qp_solve=True)
        po2, _ = jpol.forward_warm_start(p, o, carry, qp_solve=True)
        return po2["trajs"][-1][1]

    ref = jax.jit(two_ticks)(params, jnp.asarray(ranks.sharding_batch()["obs"], jnp.float64))
    np.testing.assert_allclose(one_process["streaming"]["x"].numpy(), np.asarray(ref),
                               **JAX_FWD_TOL)


@pytest.mark.slow
def test_one_process_history_forward_matches_jax(one_process):
    jpol = _pendulum_jax(JaxHistory, layer_type="mlp", fp_max_steps=4, H=ranks.HISTORY_H)
    params = _jax_params_from_port(jpol.init(jax.random.PRNGKey(0)),
                                   one_process["history"]["state"])

    def fwd(p, o):
        return jpol.forward(p, o, qp_solve=True)[0]["trajs"][-1][1]

    ref = jax.jit(fwd)(params, jnp.asarray(ranks.history_obs(), jnp.float64))
    np.testing.assert_allclose(one_process["history"]["x"].numpy(), np.asarray(ref),
                               **JAX_FWD_TOL)


def test_one_process_obstacle_solve_matches_jax(one_process):
    x0, Q, q, centers, radius, goal = ranks.obstacle_problem()
    T, nx, nu = ranks.OBSTACLE_T, 3, 3
    F = jnp.tile(jnp.concatenate([jnp.eye(nx), 0.2 * jnp.eye(nu)], axis=1)[None, None],
                 (ranks.BSZ, T - 1, 1, 1))
    dyn, dyn_jac = lin_dyn_fns(JaxLinDx(F=F, f=jnp.zeros((ranks.BSZ, T - 1, nx))))
    mpc = JaxALMPC(nx, nu, T, u_lower=-5 * np.ones(nu), u_upper=5 * np.ones(nu), dyn=dyn,
                   dyn_jac=dyn_jac, dtype=jnp.float64,
                   obstacles=JaxObstacleSet(centers=jnp.asarray(centers), radius=radius),
                   n_obs_sel=4)
    mpc.select_obstacles(jnp.broadcast_to(jnp.asarray(goal), (ranks.BSZ, T, nx)))

    def solve(x0, Q, q):
        st = mpc.init_state(x0.shape[0])
        return mpc.solve(x0, JaxQuadCost(Q=Q, q=q, f=jnp.zeros(Q.shape[:2])), st, al_iter=6)[0]

    ref = jax.jit(solve)(jnp.asarray(x0), jnp.asarray(Q), jnp.asarray(q))
    np.testing.assert_allclose(one_process["obstacle"]["x"].numpy(), np.asarray(ref),
                               **JAX_OBSTACLE_TOL)


def test_one_sided_non_spd_sample_retries_the_whole_batch(two_ranks, one_process):
    """The non-SPD sample lies in rank 1's slice only: every rank retries,
    as one process retries the whole batch, and the slices put together
    are the one-process update. Decided on each rank's own slice (the
    planted fault), rank 0 keeps its first solve and misses."""
    one = one_process["retry"]
    assert one["retries"] == 1 and [r["retry"]["retries"] for r in two_ranks] == [1, 1]
    torch.testing.assert_close(_cat(two_ranks, "retry", "update"), one["update"],
                               equal_nan=True, **PARALLEL_TOL)
    planted = [r["planted:local_retry"] for r in two_ranks]
    assert [p["retries"] for p in planted] == [0, 1]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(_cat(two_ranks, "planted:local_retry", "update"),
                                   one["update"], equal_nan=True, **PARALLEL_TOL)


def test_multihost_worker_two_processes_agree_and_match_jax(tmp_path, jax_step):
    port = _free_port()
    outs = [tmp_path / f"p{r}.json" for r in range(WORLD)]
    _wait(_start([[sys.executable, "-m", "deqmpc_tpu_torch.multihost_worker", "--process_id", str(r),
             "--num_processes", str(WORLD), "--coordinator", f"localhost:{port}",
             "--global_bsz", str(ranks.BSZ), "--out", str(outs[r]), "--device", "cpu",
             "--backend", "gloo"] for r in range(WORLD)], tmp_path))
    r0, r1 = (json.loads(o.read_text()) for o in outs)
    assert r0["process_count"] == WORLD and r0["global_devices"] == WORLD
    for key in ("loss", "grad_norm", "new_param_norm"):
        assert r0[key] == r1[key], key
    loss, gnorm, _ = jax_step
    np.testing.assert_allclose(r0["loss"], loss, rtol=JAX_LOSS_RTOL)
    np.testing.assert_allclose(r0["grad_norm"], gnorm, rtol=JAX_GNORM_RTOL)
