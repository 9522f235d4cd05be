"""Timing and tracing helpers (port of `deqmpc_tpu/utils/profiling.py`).

`PhaseTimer` accumulates host-clock seconds per named phase; a phase
whose `sync` holds CUDA tensors ends with `torch.cuda.synchronize()`, so
its time covers the device work it queued (JAX blocks on the arrays).
`device_trace` runs `torch.profiler` over its block and writes a Chrome
trace (`trace.json`, open in Perfetto) into `logdir`.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


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
    one); the Chrome trace lands in `<logdir>/trace.json`. Yields logdir."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
