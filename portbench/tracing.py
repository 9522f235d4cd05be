"""The traced run's instruments: timed ranges around the port's public
callables, set from the benchmark's files and taken off again, and one
short stretch under torch.profiler.

The ranges time the host: a range's seconds are the wall time from the
call into the wrapped callable to its return, with no sync added, so a
range holds the host's dispatch and whatever waits the callable itself
makes. Ranges nest (the Jacobians and the B1 solves run inside the AL
solve). The profiled stretch follows the window: one tick or step in the
profiler's warm-up step (a cold trace loses its first kernels), then
`ACTIVE` under trace of the device alone, the profiler kept on
`TRACE_WAIT_S` after the last sync (stopped at once, it drops a call's last
kernels); then one step traced with the host's ranges, for the breakdown.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import flops, harness

ACTIVE = 2
TRACE_WAIT_S = 0.05
B1_KERNEL = "bt_warp_kernel"
TOP = 10


class Ranges:
    """Host seconds spent inside each named range, summed; and, while
    `b1_shapes` is a list, the (bsz, T, n, element bytes) of each B1 call."""

    def __init__(self):
        self.seconds: Dict[str, float] = collections.defaultdict(float)
        self.b1_shapes: Optional[List] = None

    def totals(self) -> Dict[str, float]:
        return {f"{k}_s": v for k, v in self.seconds.items()}


def wrap(callables, ranges: Ranges) -> Callable[[], None]:
    """Wraps each (owner, attribute, range name) in a timed range and a
    `record_function` of that name; returns the function that undoes it."""
    undo = []
    for owner, attr, name in callables:
        orig = getattr(owner, attr)
        own = attr in vars(owner)
        ranges.seconds[name] += 0.0

        def wrapped(*a, _orig=orig, _name=name, **k):
            if _name == "b1" and ranges.b1_shapes is not None:
                D = a[0]
                ranges.b1_shapes.append((D.shape[0], D.shape[1], D.shape[2],
                                         D.element_size()))
            t = time.perf_counter()
            try:
                with torch.profiler.record_function(_name):
                    return _orig(*a, **k)
            finally:
                ranges.seconds[_name] += time.perf_counter() - t

        setattr(owner, attr, wrapped)
        undo.append((owner, attr, orig, own))

    def restore():
        for owner, attr, orig, own in reversed(undo):
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
    return restore


@dataclasses.dataclass
class Traced:
    steps: int
    window_s: float
    busy_s: float
    kernels: int
    b1_bound_s: Optional[float]
    b1_device_s: Optional[float]
    breakdown: Dict


def profiled_stretch(driver, ranges: Ranges, on_card: bool = True) -> Traced:
    """Two stretches after the window. The first traces the device alone: one
    step in the profiler's warm-up, then ACTIVE steps whose busy union,
    kernels and B1 launches give the device's metrics. The second traces one
    more step with the host's ranges beside the device, for the breakdown's
    idle gaps (the host's tracing slows that step, so it gives no time)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from deqmpc_tpu_torch.ops.block_tridiag import block_tridiag_solve

    names = tuple(ranges.seconds)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    device_only = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    sync()
    with profile(activities=device_only,
                 schedule=schedule(wait=0, warmup=1, active=ACTIVE, repeat=1)) as prof:
        driver.step()
        sync()
        prof.step()
        time.sleep(TRACE_WAIT_S)
        ranges.b1_shapes = []
        warp0 = block_tridiag_solve.launches_by_kernel["warp"]
        t0 = time.perf_counter()
        for i in range(ACTIVE):
            driver.step()
            sync()
            if i < ACTIVE - 1:
                prof.step()
        wall = time.perf_counter() - t0
        time.sleep(TRACE_WAIT_S)
        prof.step()
    warp = block_tridiag_solve.launches_by_kernel["warp"] - warp0
    shapes, ranges.b1_shapes = ranges.b1_shapes, None
    dev = harness.device_intervals(harness.kineto_events(prof), names)
    kernels = [d for d in dev if not d[2].startswith(("Memcpy", "Memset"))]
    b1 = [d for d in dev if B1_KERNEL in d[2]]
    bound = device = None
    if len(b1) == warp == len(shapes) and b1:
        bound = sum(flops.b1_bound_s(*s) for s in shapes)
        device = sum(e - s for s, e, _ in b1) / 1e9
    else:
        print(f"tracing: {len(b1)} {B1_KERNEL} launches in the trace, {warp} counted by the "
              f"wrapper, {len(shapes)} calls seen: no roofline", flush=True)

    with profile(activities=[ProfilerActivity.CPU] + device_only[:on_card]) as prof:
        driver.step()
        sync()
        time.sleep(TRACE_WAIT_S)
    events = harness.kineto_events(prof)
    dev_b = harness.device_intervals(events, names)
    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                  if e.device_type() == torch.autograd.DeviceType.CPU and e.name() in names)
    return Traced(steps=ACTIVE, window_s=wall, busy_s=harness.union_seconds(dev),
                  kernels=len(kernels), b1_bound_s=bound, b1_device_s=device,
                  breakdown={"device_ops": top_ops(dev), "idle_gaps": idle_gaps(dev_b, host)})


def top_ops(dev) -> List:
    """The TOP device operations by summed time, seconds."""
    total = collections.defaultdict(float)
    for s, e, name in dev:
        total[name[:80]] += (e - s) / 1e9
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:TOP]


def idle_gaps(dev, host) -> List:
    """The device's idle time between its operations, summed by the innermost
    host range open at each gap's middle ("outside" where none is): the TOP
    largest, seconds."""
    total = collections.defaultdict(float)
    stack, i = [], 0
    busy_end = None
    for s, e, _ in dev:
        if busy_end is not None and s > busy_end:
            mid = (busy_end + s) / 2
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] <= host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            total[stack[-1][2] if stack else "outside"] += (s - busy_end) / 1e9
        busy_end = e if busy_end is None else max(busy_end, e)
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:TOP]


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads: the traffic kind, the window's
    counters and range seconds per step, the profiled stretch, the window
    and the work of one step."""

    kind: str
    per_step: Dict[str, float]
    traced: Traced
    window: harness.Window
    flops_per_step: Callable[[], float]
