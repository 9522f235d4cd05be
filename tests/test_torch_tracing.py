"""The port's spans and counters (`deqmpc_tpu_torch/utils/profiling.py`) and
the tool that reads them over a benchmark cell (`portbench/program_spans.py`).

On the CPU, 4 lanes of the committed flying and rexquad checkpoints: spans
are off by default and record nothing; a tick's outputs and the solver's
counters are the same to the bit with them on; the Newton spans and the
host reads follow the policy's Newton counter; self time is total less
children (fake clock); each span shows once in a CPU torch.profiler trace,
under its parent; the cell's traced path yields the span metrics; kernels
go to the innermost span open at their launch (synthetic events)."""
from __future__ import annotations

import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from deqmpc_tpu_torch.envs import make_env_of  # noqa: E402
from deqmpc_tpu_torch.ops import block_tridiag  # noqa: E402
from deqmpc_tpu_torch.policies import build_policy  # noqa: E402
from deqmpc_tpu_torch.utils import profiling  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LANES = 4
CHECKPOINTS = ("flying_deqmpc_nn", "rexquad_deqmpc")
# each program span of a cold tick and the span it runs in
PARENT = {"policy.forward": None, "env.step": None, "network.step": "policy.forward",
          "al.solve": "policy.forward", "al.update": "al.solve", "newton.start": "al.solve",
          "newton.step": "al.solve", "newton.linearize": "newton.step",
          "newton.assemble": "newton.step", "newton.b1": "newton.step",
          "sync.finite": "newton.step", "newton.retry": "newton.step",
          "newton.line_search": "newton.step", "newton.residual": "newton.step",
          "sync.stop": "newton.step", "sync.action_bounds": "env.step"}


@pytest.fixture
def spans_on():
    """Spans on and their totals cleared for the test; off again after it."""
    profiling.reset()
    profiling.enable(True)
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.reset()


def _policy(name):
    state, args = load_checkpoint(REPO / "checkpoints" / name, "cpu")
    env = make_env_of(args)
    policy = build_policy(args, env, "cpu")
    policy.model.load_state_dict(state)
    x = env.reset(torch.Generator().manual_seed(3), LANES, device="cpu")
    return policy, env, x


def _tick(policy, env, x):
    """One closed-loop tick as the benchmark's fleet runs it."""
    with torch.inference_mode():
        out = policy.forward(x.float())
        u = out["trajs"][-1][2][:, 0]
        x_next, reward = env.step(x, u)
    return out, x_next, reward


def _flat(out, x_next, reward):
    tensors = [t for traj in out["trajs"] for t in traj]
    return tensors + [out["status"], x_next, reward]


# -- off by default --------------------------------------------------------------------------

def test_spans_are_off_by_default_in_a_fresh_process():
    code = ("from deqmpc_tpu_torch.utils import profiling as p\n"
            "a, b = p.span('x'), p.span('y')\n"
            "with a:\n    p.count('n')\n"
            "print(p.enabled(), a is b, p.totals())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split("\n")[0] == "False True {}"


def test_a_tick_with_spans_off_records_nothing():
    profiling.enable(False)
    profiling.reset()
    policy, env, x = _policy("flying_deqmpc_nn")
    _tick(policy, env, x)
    assert profiling.totals() == {}


# -- on: the same numbers, the counts the counters give ----------------------------------------

@pytest.mark.parametrize("name", CHECKPOINTS)
def test_tick_is_bitwise_the_same_with_spans_on_and_the_spans_follow_the_counters(name,
                                                                                  spans_on):
    policy, env, x = _policy(name)
    profiling.enable(False)
    s0, r0 = policy.newton_steps, policy.newton_retries
    off = _flat(*_tick(policy, env, x))
    steps, retries = policy.newton_steps - s0, policy.newton_retries - r0
    profiling.enable(True)
    profiling.reset()
    on = _flat(*_tick(policy, env, x))
    assert (policy.newton_steps - s0 - steps, policy.newton_retries - r0 - retries) == (
        steps, retries)
    assert all(torch.equal(a, b) for a, b in zip(off, on)) and len(off) == len(on)

    tot = profiling.totals()
    rounds = policy.cfg.deq_iter
    assert steps > 0
    assert tot["newton.step.calls"] == tot["newton.linearize.calls"] == steps
    assert tot["newton.b1.calls"] == tot["sync.finite.calls"] == tot["sync.stop.calls"] == steps
    assert tot.get("newton.retry.calls", 0) == retries
    # two reads a Newton step, and the action bounds' two copies in env.step
    assert tot["host_reads"] == 2 * steps + 2
    assert tot["policy.forward.calls"] == tot["env.step.calls"] == 1
    assert tot["network.step.calls"] == tot["al.solve.calls"] == rounds
    assert tot["al.update.calls"] == tot["newton.start.calls"] == rounds * policy.cfg.al_iter
    children = sum(tot.get(f"{c}.total_ns", 0) for c, p in PARENT.items() if p == "newton.step")
    assert children + tot["newton.step.self_ns"] == tot["newton.step.total_ns"]


def test_checkpoint_load_and_kernel_build_are_counted(spans_on, tmp_path, monkeypatch):
    load_checkpoint(REPO / "checkpoints" / "flying_deqmpc_nn", "cpu")
    lib = tmp_path / "k" / "libblock_tridiag.so"
    monkeypatch.setattr(block_tridiag, "library_path", lambda: lib)
    monkeypatch.setattr(block_tridiag, "_nvcc", lambda: "nvcc")

    def fake_nvcc(cmd, **kw):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(block_tridiag.subprocess, "run", fake_nvcc)
    block_tridiag.build()
    block_tridiag.build()  # found in the cache: no second nvcc run
    tot = profiling.totals()
    assert tot["checkpoint.load.calls"] == 1 and tot["checkpoint.load.total_ns"] > 0
    assert tot["kernel_builds"] == 1


# -- self time, threads -----------------------------------------------------------------------

def test_self_time_is_total_less_children_on_a_fake_clock(spans_on, monkeypatch):
    ticks = iter([0, 10, 30, 40, 50, 60, 70, 100])
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(ticks))
    with profiling.span("a"):          # 0 .. 100
        with profiling.span("b"):      # 10 .. 30
            pass
        with profiling.span("c"):      # 40 .. 70
            with profiling.span("d"):  # 50 .. 60
                pass
    tot = profiling.totals()
    assert [tot[f"a.{k}"] for k in ("calls", "total_ns", "self_ns")] == [1, 100, 50]
    assert (tot["b.total_ns"], tot["b.self_ns"]) == (20, 20)
    assert (tot["c.total_ns"], tot["c.self_ns"]) == (30, 20)
    assert (tot["d.total_ns"], tot["d.self_ns"]) == (10, 10)


def test_a_span_on_another_thread_is_not_a_child(spans_on):
    def other():
        with profiling.span("other"):
            time.sleep(0.05)

    with profiling.span("main"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    tot = profiling.totals()
    assert tot["main.self_ns"] == tot["main.total_ns"] >= tot["other.total_ns"] >= 5e7


def test_device_trace_turns_spans_on_inside_its_block(tmp_path):
    profiling.enable(False)
    with profiling.device_trace(str(tmp_path)):
        assert profiling.enabled()
        with profiling.span("traced.block"):
            torch.ones(3).sum()
    assert not profiling.enabled()
    assert "traced.block" in (tmp_path / "trace.json").read_text()
    profiling.reset()


# -- the profiler's view ------------------------------------------------------------------------

def test_every_span_shows_once_under_its_parent_in_a_cpu_profile(spans_on):
    from torch.profiler import ProfilerActivity, profile

    policy, env, x = _policy("flying_deqmpc_nn")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _tick(policy, env, x)
    events = sorted((e.start_ns(), -(e.start_ns() + e.duration_ns()), e.name())
                    for e in prof.profiler.kineto_results.events() if e.name() in PARENT)
    stack, seen = [], {}
    for s, neg_end, name in events:
        while stack and -stack[-1][1] <= s:
            stack.pop()
        assert (stack[-1][2] if stack else None) == PARENT[name], name
        stack.append((s, neg_end, name))
        seen[name] = seen.get(name, 0) + 1
    tot = profiling.totals()
    assert seen == {n: tot[f"{n}.calls"] for n in PARENT if f"{n}.calls" in tot}


# -- the benchmark cell's traced path, with the spans on -----------------------------------------

def test_the_cells_traced_path_gives_the_span_metrics_on_the_cpu(monkeypatch):
    from portbench import program_spans, tracing

    monkeypatch.setattr(tracing, "ACTIVE", 1)  # one profiled tick: the CPU has no device
    calls = iter(range(1000))  # a window clock of 1 s a reading: exactly one tick fits
    out = program_spans.trace_cell("flying_deqmpc_nn.fleet4096", 2**31 + 12345, 2.5, "cpu",
                                   mix_update={"lanes": LANES}, clock=lambda: next(calls))
    assert out["ticks"] == 1
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == {"assemble_ms.rollout", "line_search_ms.rollout", "residual_ms.rollout",
                      "sync_wait_ms.rollout", "host_syncs.rollout", "checkpoint_load_s.setup",
                      "first_tick_s.setup"}  # no kernel on the CPU: no launches, no B1 load
    assert all(v > 0 for v in m.values())
    c = out["checks"]
    assert c["newton_step_calls"] == c["newton_steps"] > 0
    assert m["host_syncs.rollout"] == pytest.approx(2 * c["newton_steps"] + 2)
    assert c["newton_step_children_plus_self_over_total"] == 1.0
    assert abs(c["al_solve_span_over_range"] - 1.0) < 0.03
    assert not profiling.enabled()


@pytest.mark.parametrize("named_activity", [True, False])
def test_kernels_go_to_the_innermost_span_open_at_their_launch(named_activity):
    from portbench import program_spans

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    class Ev:
        def __init__(self, name, dev, start, dur, tid=1, corr=0, act="cpu_op"):
            self._v = (name, dev, start, dur, tid, corr)
            if named_activity:
                self.activity_type = lambda: act

        def name(self): return self._v[0]
        def device_type(self): return self._v[1]
        def start_ns(self): return self._v[2]
        def duration_ns(self): return self._v[3]
        def start_thread_id(self): return self._v[4]
        def correlation_id(self): return self._v[5]

    def launch(t, corr, tid=1):
        return Ev("cudaLaunchKernel", cpu, t, 1, tid, corr, "cuda_runtime")

    def kernel(corr, start):
        return Ev("void elementwise_kernel<128>", cuda, start, 5, 0, corr, "kernel")

    events = [
        Ev("al.solve", cpu, 0, 1000), Ev("newton.step", cpu, 100, 400),
        Ev("newton.linearize", cpu, 110, 100), Ev("newton.b1", cpu, 300, 50),
        Ev("newton.step", cpu, 600, 300), Ev("aten::mul", cpu, 120, 10),
        Ev("other.thread", cpu, 0, 2000, tid=2),
        launch(5, 1), launch(130, 2), launch(150, 3), launch(310, 4), launch(450, 5),
        launch(700, 6), launch(1500, 7), launch(800, 8, tid=2),
        # the device runs the kernels later, in another order: the launch decides
        kernel(7, 3000), kernel(2, 2000), kernel(3, 2010), kernel(4, 2020), kernel(5, 2030),
        kernel(6, 2040), kernel(1, 1990), kernel(8, 2050), kernel(9, 2060),
        Ev("Memcpy HtoD (Pageable -> Device)", cuda, 2070, 5, 0, 5, "gpu_memcpy"),
        Ev("newton.step", cuda, 2080, 5, 0, 0, "gpu_user_annotation"),
    ]
    names = {"al.solve", "newton.step", "newton.linearize", "newton.b1", "other.thread"}
    by_span, n = program_spans.launches_by_span(events, names)
    assert by_span == {"al.solve": 1, "newton.linearize": 2, "newton.b1": 1, "newton.step": 2,
                       "outside": 1, "other.thread": 1, "unmatched": 1}
    assert n == {"kernels": 9, "matched": 8}
