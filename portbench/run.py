"""Runs one cell of BENCHMARK.json on the card and prints its result line.

  python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`, whose `kind` names the driver `traffic/<kind>.py`).
Set-up (from process start: the checkpoint, the kernel build from its cache,
the data, the warm-up at the cell's own shapes) is `setup_s`. The window
then runs whole ticks or steps for `--seconds` (`harness.run_window`). With
`--trace 1` the port's public callables are wrapped in timed ranges for the
window, and after it a short stretch runs under torch.profiler; each
per-layer metric of the cell is read by `metrics/<metric>.py`. Last, the
program's state is freed and the reference decides `correct`
(`limits/<workload>.json` holds each compared number's limit).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # one process with few threads: the port's work is on the card, and an
    # OpenMP pool as wide as the host only competes with the dispatching thread
    os.environ["OMP_NUM_THREADS"] = "1"
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"  # every build and kernel cache, at a fixed path
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness, tracing  # noqa: E402

def use_cache_dirs() -> None:
    """Every build and kernel cache a library may keep, inside the checkout
    at a fixed path (the port builds its kernel into its own
    `deqmpc_tpu_torch/ops/_build/`); no library may load flax."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, root: Path = ROOT):
    """(cell, config, mix, its end-to-end metrics, its per-layer metrics) from
    `root`'s BENCHMARK.json and the files of `root`/portbench."""
    bench_dir = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"run.py: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = json.loads((bench_dir / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    return cell, config, mix, e2e, per_layer


def make_driver(config, mix, seed, device="cuda", root: Path = ROOT):
    kind = load_module(root / "portbench" / "traffic" / f"{mix['kind']}.py",
                       f"portbench_kind_{mix['kind']}")
    return kind.Driver(root, config, mix, seed, device)


def compare(readings: dict, limits: dict) -> dict:
    """Each compared number beside its limit; a number passes at or below it."""
    return {k: {"value": readings[k], "limit": lim, "ok": bool(readings[k] <= lim)}
            for k, lim in limits.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    use_cache_dirs()
    cell = load_cell(a.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"run.py: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    line = run_cell(a.workload, a.seed, a.seconds, a.trace, "cuda")
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"run.py: the process holds {loaded} once the window has closed", file=sys.stderr)
        return 3
    print(line, flush=True)
    return 0


def run_cell(workload: str, seed: int, seconds: float, trace: int, device: str,
             mix_update=None, root: Path = ROOT) -> str:
    """Set-up, window, the traced stretch with `trace`, the check; returns the
    result line. `mix_update` and `root` serve the CPU tests: a smaller mix,
    and another tree of BENCHMARK.json and portbench/."""
    cell, config, mix, e2e, per_layer = load_cell(workload, root)
    mix = {**mix, **(mix_update or {})}
    bench_dir = root / "portbench"
    limits = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())["limits"]
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    driver = make_driver(config, mix, seed, device, root)
    driver.setup()
    sync()
    setup_s = time.perf_counter() - T_START

    ranges = tracing.Ranges() if trace else None
    undo = tracing.wrap(driver.layer_callables(), ranges) if trace else (lambda: None)
    probe = (lambda: {**driver.counters(), **ranges.totals()}) if trace else driver.counters
    window = harness.run_window(driver.step, seconds, sync=sync, probe=probe)
    failed = driver.failed(window.steps)
    breakdown, traced = None, None
    if trace:
        traced = tracing.profiled_stretch(driver, ranges, on_card)
        undo()
        per_step = {k: (window.probe_end[k] - window.probe_start.get(k, 0.0)) / window.steps
                    for k in window.probe_end}
        ctx = tracing.Context(kind=mix["kind"], per_step=per_step, traced=traced,
                              window=window, flops_per_step=lambda: driver.flops_per_step(per_step))
        metrics = {}
        for m in per_layer:
            reader = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                 f"portbench_metric_{m['name'].replace('.', '_')}")
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = traced.breakdown
    else:
        metrics = driver.end_to_end(window)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        metrics = {m["name"]: metrics[m["name"]] for m in e2e}
    device_desc = harness.device_info(int(cell["chips"])) if on_card else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace:
        device_desc.update(busy_s=traced.busy_s, window_s=traced.window_s)
    driver.release()

    print(f"reading step_seconds: {window.step_seconds!r}", file=sys.stderr)
    readings = driver.check(window.steps)
    checks = compare(readings, limits)
    for k, v in readings.items():
        if k not in checks:
            print(f"reading {k}: {v!r}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAIL'}",
              file=sys.stderr, flush=True)
    return harness.result_line(all(c["ok"] for c in checks.values()), window.work, failed,
                               metrics, device_desc,
                               {k: {"value": c["value"], "limit": c["limit"]}
                                for k, c in checks.items()}, breakdown)


if __name__ == "__main__":
    sys.exit(main())
