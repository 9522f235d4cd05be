"""The readings that the limits of `correct` are set from, on the card.

For one fleet cell, in one process: the program set up once, then for each
of `--seeds` the lanes reset from the seed, `--ticks` ticks run, and the
numbers that `run.py` compares, program against reference; for the first
`--control` seeds also the control (the reference with TF32 on) against the
reference; then each of `--faults` (`faults.py`) planted in the program for
each of `--fault-seeds`. One JSON line per reading.

  python portbench/calibrate.py --workload flying_deqmpc_nn.fleet4096 \
      --seeds 101 102 ... --control 4 [--ticks 3] [--out chiprun_out/calib.jsonl] \
      [--faults half_unsolved --fault-seeds 201 202 203]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import faults, run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control")
    ap.add_argument("--ticks", type=int, default=3, help="ticks a seed")
    ap.add_argument("--out", default=None)
    ap.add_argument("--faults", nargs="*", default=[], help="faults.py's names")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    cell, config, mix, _, _ = run.load_cell(a.workload)
    out = open(a.out, "a") if a.out else None
    driver = None
    runs = [(seed, i < a.control, None) for i, seed in enumerate(a.seeds)]
    runs += [(seed, False, f) for f in a.faults for seed in a.fault_seeds]
    for seed, control, fault in runs:
        t = time.perf_counter()
        if driver is None:
            driver = run.make_driver(config, mix, seed)
            driver.setup()
        else:
            driver.restart(seed)
        mp = pytest.MonkeyPatch()
        if fault:
            faults.FAULTS[fault](mp)
        for _ in range(a.ticks):
            driver.step()
        torch.cuda.synchronize()
        mp.undo()
        rows = [(fault or "program", driver.check(a.ticks))]
        if control:
            rows.append(("control", driver.check(a.ticks, control=True)))
        for who, r in rows:
            line = json.dumps({"workload": a.workload, "seed": seed, "who": who, **r,
                               "counters": driver.counters(),
                               "s": time.perf_counter() - t})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()
