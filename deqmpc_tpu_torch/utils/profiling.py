"""Timing and tracing helpers (port of `deqmpc_tpu/utils/profiling.py`).

`PhaseTimer` accumulates host-clock seconds per named phase; a phase
whose `sync` holds CUDA tensors ends with `torch.cuda.synchronize()`, so
its time covers the device work it queued (JAX blocks on the arrays).
`device_trace` runs `torch.profiler` over its block and writes a Chrome
trace (`trace.json`, open in Perfetto) into `logdir`, with the spans on.

Spans and counters, the program's own tracing. `span(name)` marks one
layer of the tick (`policy.forward`, `al.solve`, `newton.step`, ...);
`count(name, n)` adds to a counter where the work happens (`host_reads`,
`kernel_builds`). Both are off by default: `span` then returns one shared
no-op context and `count` returns, after one check of a module-level
boolean. `enable(True)` turns them on. A span then records its host-clock
interval (`time.perf_counter_ns`) and opens a
`torch.profiler.record_function` of its name, so a running profile stamps
it on the device trace's own clock. Spans nest on a stack per thread (the
implicit backward runs on autograd's thread). Only totals are kept:
`totals()` reads, for every span, its calls, total ns and self ns (the
total less the time its child spans cover), and every counter's sum; the
timeline of single spans is the profiler's trace.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict

import torch

_on = False
_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_spans: Dict[str, list] = {}    # name -> [calls, total ns, self ns]
_counts: Dict[str, int] = {}
_local = threading.local()


def enable(on: bool) -> None:
    """Turns spans and counters on or off (off at import)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def current():
    """The name of the innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1].name if stack else None


def reset() -> None:
    """Forgets every total and counter."""
    with _lock:
        _spans.clear()
        _counts.clear()


def totals() -> Dict[str, float]:
    """Flat totals: `<span>.calls`, `<span>.total_ns` and `<span>.self_ns`
    for every span name, and every counter by its own name."""
    with _lock:
        out: Dict[str, float] = {}
        for name, (calls, total, own) in _spans.items():
            out[f"{name}.calls"] = calls
            out[f"{name}.total_ns"] = total
            out[f"{name}.self_ns"] = own
        out.update(_counts)
        return out


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name` while tracing is on."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def span(name: str):
    """A context that records the layer `name` while tracing is on."""
    if not _on:
        return _NOOP
    return _Span(name)


class _Span:
    __slots__ = ("name", "record", "t0", "children")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.children = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].children += dt
        with _lock:
            tot = _spans.get(self.name)
            if tot is None:
                tot = _spans[self.name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += dt
            tot[2] += dt - self.children
        self.record.__exit__(*exc)
        return False


def _holds_cuda(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, dict):
        return any(_holds_cuda(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_holds_cuda(v) for v in obj)
    return False


class PhaseTimer:
    """Mean host-clock seconds per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if _holds_cuda(sync):
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def report(self) -> str:
        return "  ".join(f"{k}={v * 1e3:.1f}ms" for k, v in sorted(self.summary().items()))


@contextlib.contextmanager
def device_trace(logdir: str = "logs/deqmpc_trace"):
    """torch.profiler over the block (the card's activity too when there is
    one), with the program's spans on; the Chrome trace lands in
    `<logdir>/trace.json`. Yields logdir."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = _on
    enable(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield logdir
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        enable(was_on)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
