"""The whole-tick window on a fake clock, and the result line."""
import json

import pytest

from portbench import harness


class FakeClock:
    """A clock that moves only when a step runs: each step takes the next
    of `durations` seconds."""

    def __init__(self, durations):
        self.t, self.durations = 0.0, list(durations)

    def __call__(self):
        return self.t

    def step(self):
        self.t += self.durations.pop(0)
        return 100  # lane-ticks


def window(durations, seconds):
    clock = FakeClock(durations)
    return harness.run_window(clock.step, seconds, clock=clock, sync=lambda: None)


def test_partial_tick_is_not_counted():
    # ticks of 4 s in a 10 s window: two end inside it (at 4 and 8 s); the
    # third, started at 8 s, ends at 12 s and counts neither its work nor time
    w = window([4.0] * 5, 10.0)
    assert (w.steps, w.work, w.seconds, w.overrun) == (2, 200, 8.0, True)
    assert w.rate() == pytest.approx(25.0)
    assert w.ms_per_step() == pytest.approx(4000.0)


def test_rate_is_whole_work_over_whole_time():
    # a tick ending exactly at the deadline counts
    w = window([2.5] * 6, 10.0)
    assert (w.steps, w.seconds) == (4, 10.0)
    assert w.rate() == pytest.approx(40.0)


def test_stall_inside_the_window_lowers_the_rate():
    steady = window([1.0] * 20, 10.0)
    stalled = window([1.0, 1.0, 4.0] + [1.0] * 20, 10.0)
    assert stalled.rate() < steady.rate()
    assert stalled.steps == 7 and stalled.seconds == pytest.approx(10.0)


def test_probe_reads_at_the_last_counted_tick():
    clock = FakeClock([3.0] * 5)
    counts = {"n": 0}

    def step():
        counts["n"] += 1
        return clock.step()

    w = harness.run_window(step, 10.0, clock=clock, sync=lambda: None,
                           probe=lambda: dict(counts))
    assert w.probe_start == {"n": 0} and w.probe_end == {"n": 3} and counts["n"] == 4


def test_no_completed_tick_raises():
    with pytest.raises(RuntimeError):
        window([11.0], 10.0)


def test_result_line_keys_and_checks_last():
    line = harness.result_line(True, 400, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                               {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                                "count": 1, "memory_peak_bytes": 10},
                               {"step_gap": {"value": 0.0, "limit": 0.0}},
                               breakdown={"device_ops": [], "idle_gaps": []})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d["device"])


def test_union_of_device_intervals():
    iv = [(0, 10, "a"), (5, 20, "b"), (30, 40, "c")]
    assert harness.union_seconds(iv) == pytest.approx(30e-9)


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["deqmpc_tpu_torch", "deqmpc_tpu_torch.ops", "torch", "jaxtyping", "portbench.ref"]
    assert harness.forbidden_loaded(mods) == []
    assert harness.forbidden_loaded(mods + ["deqmpc_tpu.solvers", "jax"]) == ["deqmpc_tpu", "jax"]
