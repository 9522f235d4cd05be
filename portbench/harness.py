"""What every cell shares: the whole-tick window, the device's description,
the profiler's device intervals and their union, and the result line."""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# module top-level names that no process printing a result may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "deqmpc_tpu")


@dataclass
class Window:
    """The steps that completed inside the window: `steps` of them, `work`
    units (lane-ticks, samples) in all, over `seconds` from the window's
    opening sync to the sync that closed the last of them. `overrun` is
    whether a step was still running at the deadline: it was finished and
    left out of both. `probe_start` and `probe_end` are what `probe()` read
    at the opening sync and at the sync of the last step counted;
    `step_seconds` the time of each step counted."""

    steps: int
    work: int
    seconds: float
    overrun: bool
    probe_start: Optional[Dict] = None
    probe_end: Optional[Dict] = None
    step_seconds: Optional[List[float]] = None

    def rate(self) -> float:
        """Work per second over the whole window."""
        return self.work / self.seconds

    def ms_per_step(self) -> float:
        return self.seconds / self.steps * 1e3


def run_window(step: Callable[[], int], seconds: float,
               clock: Callable[[], float] = time.perf_counter,
               sync: Callable[[], None] = torch.cuda.synchronize,
               probe: Optional[Callable[[], Dict]] = None) -> Window:
    """Runs `step()` (which returns the work it did) while less than
    `seconds` has passed since the opening sync. The window ends at the sync
    that closed the last step completed inside `seconds`; a step that ends
    after the deadline counts neither its work nor its time."""
    probe = probe or (lambda: None)
    sync()
    t0 = clock()
    first = last = probe()
    t_last, steps, work, overrun, each = t0, 0, 0, False, []
    while clock() - t0 < seconds:
        w = step()
        sync()
        t = clock()
        if t - t0 > seconds:
            overrun = True
            break
        each.append(t - t_last)
        t_last, steps, work, last = t, steps + 1, work + w, probe()
    if steps == 0:
        raise RuntimeError(f"no step completed inside the {seconds} s window")
    return Window(steps=steps, work=work, seconds=t_last - t0, overrun=overrun,
                  probe_start=first, probe_end=last, step_seconds=each)


def power_limit_w() -> Optional[float]:
    """The card's power limit from nvidia-smi, or None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None


def device_info(count: int) -> Dict:
    """The result line's `device`: the platform, the card's name, the cards
    used and the peak memory on the fullest of them."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count)),
            "power_limit_w": power_limit_w()}


def check_args(config: Dict, args: Dict) -> None:
    """The checkpoint's args must be the configuration's, key by key."""
    for k, v in config["args"].items():
        if args.get(k) != v:
            raise ValueError(f"checkpoint {config['checkpoint']}: {k} is {args.get(k)!r}, "
                             f"the configuration says {v!r}")


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def kineto_events(prof) -> list:
    return list(prof.profiler.kineto_results.events())


def is_device_work(e, annotations=()) -> bool:
    """Whether a profiler event is a kernel, copy or set on the device: not
    the device-side mirror of a host range (`record_function`, the
    profiler's steps)."""
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind()) in DEVICE_ACTIVITIES
    mark = getattr(e, "is_user_annotation", None)
    if mark is not None and mark():
        return False
    name = e.name()
    return not (name.startswith("ProfilerStep") or name in annotations)


def device_intervals(events, annotations=()) -> List[Tuple[int, int, str]]:
    """(start ns, end ns, name) of every kernel, copy and set among a
    profile's events on the device, in order of start."""
    out = []
    for e in events:
        if is_device_work(e, annotations):
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return sorted(out)


def union_seconds(intervals: Sequence[Tuple[int, int, str]]) -> float:
    """Seconds in which at least one of the (sorted) intervals was running."""
    total, cur_s, cur_e = 0, None, None
    for s, e, _ in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def forbidden_loaded(modules=None) -> List[str]:
    """The top-level names of `sys.modules` (the part before the first dot,
    compared whole) that are JAX's or the JAX package's."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict, device: Dict,
                checks: Dict, breakdown: Optional[Dict] = None) -> str:
    """The last line of standard output; the numbers compared, each beside its
    limit, come last under `checks`."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
