"""The program's own spans and counters over a cell's traced path.

  python portbench/program_spans.py --workload <name> --seed <n> --seconds <s> [--out f.json]
  python portbench/program_spans.py --workload <name> --seed <n> --seconds <s> --overhead 3

The first form runs the cell as `run.py --trace 1` does, with the program's
spans (`deqmpc_tpu_torch.utils.profiling`) on from before set-up: the window
under the outside ranges of `tracing.wrap`, then `tracing.profiled_stretch`
with the program's span names among its host ranges, so the breakdown's
idle gaps go to the innermost program span. Then one more tick under
torch.profiler, host and device, whose kernels are each given to the
innermost program span open when the host launched them (the kernel matched
to its runtime launch event by correlation id), and, on the card, one tick
under `torch.cuda.set_sync_debug_mode("warn")`, whose warnings name every
place where the host waited for the device. It prints one JSON line: the
span metrics (`ROLLOUT`, `SETUP`), the split of a tick by span, the kernels
per span, the sync sites, and the checks of the spans against the outside
ranges and the policy's counters.

With `--overhead k` it times, after one set-up, k windows with the spans
off and k with them on, in turns, and the cost of one span site off and on.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Iterable, List, Optional, Tuple  # noqa: E402

if __name__ == "__main__":
    os.environ["OMP_NUM_THREADS"] = "1"  # as run.py sets it
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from deqmpc_tpu_torch.utils import profiling  # noqa: E402
from portbench import harness, run, tracing  # noqa: E402

# the children of one `newton.step`: each measured once, none overlapping
NEWTON_CHILDREN = ("newton.linearize", "newton.assemble", "newton.b1", "sync.finite",
                   "newton.retry", "newton.line_search", "newton.residual", "sync.stop")
RUNTIME_ACTIVITIES = ("cuda_runtime", "cuda_driver")
SYNC_WARNING = "called a synchronizing CUDA operation"


def _total(totals: Dict, names, scale: float) -> Optional[float]:
    """The summed total of the spans `names`, times `scale`; None where
    none of them ran."""
    keys = [f"{n}.total_ns" for n in names]
    if not any(k in totals for k in keys):
        return None
    return sum(totals.get(k, 0.0) for k in keys) * scale


def _sync_spans(totals: Dict) -> List[str]:
    return sorted(k[:-len(".total_ns")] for k in totals
                  if k.startswith("sync.") and k.endswith(".total_ns"))


# metric -> (unit, its reader of the window's per-tick deltas `d` and the
# kernels per span of one profiled tick `k`, None off the card)
ROLLOUT = {
    "assemble_ms.rollout": ("ms", lambda d, k: _total(d, ["newton.assemble"], 1e-6)),
    "line_search_ms.rollout": ("ms", lambda d, k: _total(d, ["newton.line_search"], 1e-6)),
    "residual_ms.rollout": ("ms", lambda d, k: _total(
        d, ["newton.start", "newton.residual", "al.update"], 1e-6)),
    "sync_wait_ms.rollout": ("ms", lambda d, k: _total(d, _sync_spans(d), 1e-6)),
    "host_syncs.rollout": ("reads", lambda d, k: d.get("host_reads")),
    "jacobian_launches.rollout": ("kernels", lambda d, k: None if k is None
                                  else float(k.get("newton.linearize", 0))),
}
# metric -> (unit, its reader of the totals at the window's opening, when
# only set-up has run)
SETUP = {
    "checkpoint_load_s.setup": ("s", lambda o: _total(o, ["checkpoint.load"], 1e-9)),
    "kernel_load_s.setup": ("s", lambda o: _total(o, ["b1.load"], 1e-9)),
    "first_tick_s.setup": ("s", lambda o: _total(o, ["policy.forward", "env.step"], 1e-9)),
}


def span_names(totals: Dict) -> List[str]:
    return sorted({k[:-len(".calls")] for k in totals if k.endswith(".calls")})


def innermost(spans: Iterable[Tuple[int, int, int, str]],
              points: Iterable[Tuple[int, int]]) -> List[str]:
    """For each (thread, ns) point, the name of the innermost of the
    (thread, start ns, end ns, name) spans that holds it on that thread
    ("outside" where none does). Spans of one thread nest."""
    by_thread = collections.defaultdict(list)
    for tid, s, e, name in spans:
        by_thread[tid].append((s, -e, name))
    points = list(points)
    out: List[str] = ["outside"] * len(points)
    order = sorted(range(len(points)), key=lambda i: points[i])
    stack, j, thread, opened = [], 0, None, []
    for i in order:
        tid, t = points[i]
        if tid != thread:
            thread, stack, j = tid, [], 0
            opened = sorted(by_thread.get(tid, []))
        while j < len(opened) and opened[j][0] <= t:
            while stack and -stack[-1][1] < opened[j][0]:
                stack.pop()
            stack.append(opened[j])
            j += 1
        while stack and -stack[-1][1] < t:
            stack.pop()
        if stack:
            out[i] = stack[-1][2]
    return out


def _activity(e) -> str:
    """The profiler event's activity ("kernel", "cuda_runtime", ...); from
    its name where this PyTorch has no `activity_type`."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind())
    if e.device_type() == torch.autograd.DeviceType.CPU:
        return "cuda_runtime" if e.name().startswith(("cuda", "cu")) else "cpu_op"
    return "gpu_memcpy" if e.name().startswith(("Memcpy", "Memset")) else "kernel"


def launches_by_span(events, names) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Kernels of a profile by the innermost of the spans named `names` open
    on the host when the kernel was launched: each kernel goes to the runtime
    event of its correlation id (`cudaLaunchKernel` and the like), and that
    event's host start and thread to the spans. Returns (kernels per span
    name, {"kernels", "matched"}): a kernel whose launch is not in the
    profile is counted under "unmatched"."""
    names = set(names)
    spans, launch, kernels = [], {}, []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name() in names:
                spans.append((e.start_thread_id(), e.start_ns(),
                              e.start_ns() + e.duration_ns(), e.name()))
            elif _activity(e) in RUNTIME_ACTIVITIES:
                launch[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        elif harness.is_device_work(e, names) and _activity(e) == "kernel":
            kernels.append(e.correlation_id())
    points = [launch[c] for c in kernels if c in launch]
    out = collections.Counter(innermost(spans, points))
    if len(points) < len(kernels):
        out["unmatched"] = len(kernels) - len(points)
    return dict(out), {"kernels": len(kernels), "matched": len(points)}


def profile_tick(driver, names, on_card: bool):
    """One tick under torch.profiler, host and device: (kernels per span,
    {"kernels", "matched", "newton_steps"})."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    steps = driver.counters()["newton_steps"]
    sync()
    with profile(activities=acts) as prof:
        driver.step()
        sync()
        time.sleep(tracing.TRACE_WAIT_S)
    by_span, n = launches_by_span(harness.kineto_events(prof), names)
    return by_span, {**n, "newton_steps": driver.counters()["newton_steps"] - steps}


def sync_sites(driver) -> Tuple[Dict[str, int], int]:
    """One tick with the card's sync debug mode on: each place where the
    host waited ("file:line in <innermost program span>", "outside" where
    none was open) with its count, and the `host_reads` counted over the
    same tick."""
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        key = f"{os.path.relpath(filename, ROOT)}:{lineno} in {profiling.current() or 'outside'}"
        if SYNC_WARNING in str(message):
            sites[key] += 1

    before = profiling.totals().get("host_reads", 0)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            driver.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dict(sites), profiling.totals().get("host_reads", 0) - before


def set_up(workload: str, seed: int, device: str, mix_update=None, root: Path = ROOT):
    """The cell's driver, set up with the spans on from its start: (cell,
    driver, setup_s from process start, the set-up's span metrics and
    `kernel_builds`). The spans are left on."""
    cell, config, mix, _, _ = run.load_cell(workload, root)
    profiling.reset()
    profiling.enable(True)
    driver = run.make_driver(config, {**mix, **(mix_update or {})}, seed, device, root)
    driver.setup()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    opening = profiling.totals()
    setup = {name: read(opening) for name, (_, read) in SETUP.items()}
    return cell, driver, setup_s, {**setup, "kernel_builds": opening.get("kernel_builds", 0)}


def trace_cell(workload: str, seed: int, seconds: float, device: str = "cuda",
               mix_update=None, root: Path = ROOT, clock=time.perf_counter) -> Dict:
    """The cell's traced path with the program's spans on (module docstring);
    `mix_update`, `root` and the window's `clock` as `run.run_cell` and
    `harness.run_window` take them."""
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    try:
        cell, driver, setup_s, setup = set_up(workload, seed, device, mix_update, root)
        ranges = tracing.Ranges()
        undo = tracing.wrap(driver.layer_callables(), ranges)
        probe = lambda: {**driver.counters(), **ranges.totals(), **profiling.totals()}  # noqa: E731
        window = harness.run_window(driver.step, seconds, clock=clock, sync=sync, probe=probe)
        d = {k: (window.probe_end[k] - window.probe_start.get(k, 0.0)) / window.steps
             for k in window.probe_end}
        undo()
        # the stretch's host ranges, and so the breakdown's idle gaps, are
        # the program's spans alone
        names = span_names(profiling.totals())
        ranges.seconds = collections.defaultdict(float, dict.fromkeys(names, 0.0))
        traced = tracing.profiled_stretch(driver, ranges, on_card)
        kernels, matched = profile_tick(driver, names, on_card)
        sites, reads = sync_sites(driver) if on_card else (None, None)
    finally:
        profiling.enable(False)
    k = kernels if on_card else None
    values = {name: (unit, read(d, k)) for name, (unit, read) in ROLLOUT.items()}
    values.update({name: (unit, setup[name]) for name, (unit, _) in SETUP.items()})
    metrics = {name: {"value": v, "unit": unit} for name, (unit, v) in values.items()
               if v is not None}
    split = {n: {"calls": d.get(f"{n}.calls", 0.0), "total_ms": d[f"{n}.total_ns"] / 1e6,
                 "self_ms": d[f"{n}.self_ns"] / 1e6}
             for n in names if d.get(f"{n}.calls")}
    children = sum(d.get(f"{n}.total_ns", 0.0) for n in NEWTON_CHILDREN)
    checks = {
        "al_solve_span_over_range": d["al.solve.total_ns"] / 1e9 / d["al_solve_s"],
        "newton_step_calls": d["newton.step.calls"], "newton_steps": d["newton_steps"],
        "launches_a_tick": traced.kernels / traced.steps if on_card else None,
        "newton_step_children_plus_self_over_total":
            (children + d["newton.step.self_ns"]) / d["newton.step.total_ns"],
    }
    if on_card:
        inside = sum(c for s, c in sites.items() if not s.endswith(" in outside"))
        checks.update(sync_sites_inside_spans=inside, host_reads_that_tick=reads)
    return {"workload": workload, "seed": seed, "setup_s": setup_s,
            "kernel_builds": setup["kernel_builds"], "ticks": window.steps,
            "tick_s": window.seconds / window.steps, "metrics": metrics, "split": split,
            "kernels_by_span": kernels, "kernels_matched": matched, "sync_sites": sites,
            "checks": checks, "breakdown": traced.breakdown,
            "device": harness.device_info(int(cell["chips"])) if on_card else {"kind": "cpu"}}


def span_cost_ns(n: int = 200_000) -> Dict[str, float]:
    """Host ns of one empty span site and one counter site, off and on."""
    out = {}
    was = profiling.enabled()
    for on in (False, True):
        profiling.enable(on)
        t = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("cost.probe"):
                pass
        out[f"span_{'on' if on else 'off'}_ns"] = (time.perf_counter_ns() - t) / n
        t = time.perf_counter_ns()
        for _ in range(n):
            profiling.count("cost.probe")
        out[f"count_{'on' if on else 'off'}_ns"] = (time.perf_counter_ns() - t) / n
    profiling.enable(was)
    return out


def overhead(workload: str, seed: int, seconds: float, k: int, device: str = "cuda",
             mix_update=None) -> Dict:
    """2k windows after one set-up (the set-up's spans on): k with the spans
    off and k on, in the order off, on, on, off, off, on, ..., so that a
    steady drift of the host's pace weighs on both sides alike; each
    window's rate, the spans and host reads of a tick, and the cost of one
    span and counter site."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    cell, driver, setup_s, setup = set_up(workload, seed, device, mix_update)
    rates = {"off": [], "on": []}
    spans = reads = ticks_on = 0
    for i in range(k):
        for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
            profiling.enable(side == "on")
            w = harness.run_window(driver.step, seconds, sync=sync, probe=profiling.totals)
            rates[side].append(w.rate())
            if side == "on":
                d = {key: v - w.probe_start.get(key, 0) for key, v in w.probe_end.items()}
                spans += sum(v for key, v in d.items() if key.endswith(".calls"))
                reads += d["host_reads"]
                ticks_on += w.steps
    profiling.enable(False)
    return {"workload": workload, "seed": seed, "seconds": seconds, "setup_s": setup_s,
            "setup": setup, "rates": rates, "spans_a_tick": spans / ticks_on,
            "host_reads_a_tick": reads / ticks_on, **span_cost_ns(),
            "device": harness.device_info(int(cell["chips"]))
            if torch.device(device).type == "cuda" else {"kind": "cpu"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--overhead", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    run.use_cache_dirs()
    if not torch.cuda.is_available():
        print("program_spans.py: needs a CUDA device", file=sys.stderr)
        return 2
    if a.overhead:
        out = overhead(a.workload, a.seed, a.seconds, a.overhead)
    else:
        out = trace_cell(a.workload, a.seed, a.seconds)
    line = json.dumps(out)
    if a.out:
        Path(a.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
