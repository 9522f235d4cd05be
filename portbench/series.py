"""Runs one cell several times in a row, one process a run, and reports
each metric's median and spread.

The spread is the distance between the first and third quartiles of
`statistics.quantiles(values, n=4)`, as a share of the median. Each run's
result line goes to `--out` (JSON lines), with the seed and the run's
seconds.

  python portbench/series.py --workload <name> --seconds 40 --seeds 11 12 13 \
      [--trace 0] [--out chiprun_out/series.jsonl]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    values = {}
    for seed in a.seeds:
        t = time.perf_counter()
        res = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                              "--workload", a.workload, "--seed", str(seed),
                              "--seconds", str(a.seconds), "--trace", str(a.trace)],
                             capture_output=True, text=True, cwd=ROOT)
        wall = time.perf_counter() - t
        last = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
        try:
            line = json.loads(last)
        except json.JSONDecodeError:
            line = {"error": res.returncode, "stderr": res.stderr[-4000:]}
        line.update(seed=seed, run_s=wall, rc=res.returncode,
                    readings=[x for x in res.stderr.splitlines()
                              if x.startswith(("reading ", "check "))])
        print(json.dumps(line), flush=True)
        if res.returncode != 0 or not line.get("correct"):
            print(res.stderr[-3000:], file=sys.stderr, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        for k, m in line.get("metrics", {}).items():
            values.setdefault(k, []).append(m["value"])
    summary = {k: {"median": statistics.median(v), "spread": spread(v) if len(v) > 1 else None,
                   "n": len(v)} for k, v in values.items()}
    print(json.dumps({"workload": a.workload, "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
