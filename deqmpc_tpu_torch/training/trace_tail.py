"""How often torch.profiler loses kernels of a traced call, and where.

PROCS processes at once each trace REPS calls of one block-tridiagonal
solve through the warp kernel, OPS small elementwise kernels (about the
kernels of a served tick; calls of 300 lost nothing), every MARK-th of
them a negation that marks its place, and one more solve, in the WAYS
named on the command line: the call started as the profiler starts and
the profiler stopped right after its sync (`no_wait`); stopped WAIT_S
seconds later (`wait_after`); also started WAIT_S seconds after the
profiler (`wait_before_and_after`); started LONG_WAIT_S after it (`long_wait_before`); and
as `wait_before_and_after` under a lock that the processes share, so
that one traces at a time while the others run the call untraced
(`serial`); and as `wait_before_and_after` after one untraced run of the
call in the profiler's warm-up step (`warmup_call`). For each way it counts the
traces that lost kernels: any, the first solve or the first mark (the
head), the last solve or the last mark (the tail), a mark between them;
the fewest kernels and marks a trace held, the most kernels it lost,
and the first kept kernel's start in the trace (ms), least and most.
Prints one JSON line. Needs the card.

  python -m deqmpc_tpu_torch.training.trace_tail [--ways serial,no_wait] [--reps 20]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import fcntl
import json
import multiprocessing as mp
import os
import tempfile
import time

import torch

PROCS, REPS, OPS, MARK, WAIT_S, LONG_WAIT_S = 6, 20, 30000, 500, 0.05, 0.5
# way: (the wait before the call, the wait after its sync, one trace at a time,
# the call run once first in the profiler's warm-up step)
WAYS = {"no_wait": (0.0, 0.0, False, False), "wait_after": (0.0, WAIT_S, False, False),
        "wait_before_and_after": (WAIT_S, WAIT_S, False, False),
        "long_wait_before": (LONG_WAIT_S, WAIT_S, False, False),
        "serial": (WAIT_S, WAIT_S, True, False), "warmup_call": (WAIT_S, WAIT_S, False, True)}


def _traced(fn, head_s, tail_s, warmup=False):
    """The kernels the profiler recorded, each as "warp", "mark" or "op",
    in the order they ran, and the first one's start in the trace (ms)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from ..ops import block_tridiag as bt

    torch.cuda.synchronize()
    sched = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup else None
    with profile(activities=[ProfilerActivity.CUDA], schedule=sched) as prof:
        if warmup:
            fn()
            torch.cuda.synchronize()
            prof.step()
        time.sleep(head_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(tail_s)
        if warmup:
            prof.step()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    return (["warp" if bt.KERNEL_FUNCTIONS["warp"] in e.name else
             "mark" if "neg_kernel" in e.name else "op" for e in kernels],
            kernels[0].time_range.start / 1e3 if kernels else None)


def _in_turn(lock_path, fn, busy):
    """`fn()` while holding the lock at `lock_path`; `busy()` over and
    over while another process holds it."""
    with open(lock_path, "a") as f:
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                busy()
        try:
            return fn()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _losses(kinds):
    """Where a trace lost kernels: (any, head, tail, middle). The head is
    the first solve and the first mark; the tail the last mark's stretch
    and the last solve; the middle any two marks it kept that are not
    MARK kernels apart."""
    marks = [i for i, k in enumerate(kinds) if k == "mark"]
    head = kinds[:2] != ["warp", "mark"]
    tail = len(kinds) <= MARK or kinds[-1] != "warp" or kinds[-MARK - 1] != "mark"
    middle = any(b - a != MARK for a, b in zip(marks, marks[1:]))
    return len(kinds) < OPS + 2, head, tail, middle


def _worker(job):
    ways, reps, lock_path = job
    from ..ops import block_tridiag as bt

    torch.set_num_threads(2)
    D = 2 * torch.eye(3, device="cuda").expand(32, 5, 3, 3).contiguous()
    O = torch.zeros(32, 4, 3, 3, device="cuda")
    b = torch.ones(32, 5, 3, device="cuda")
    y = torch.zeros(64, device="cuda")

    def call():
        bt.block_tridiag_solve(D, O, b)
        z = y
        for i in range(OPS):
            z = -z if i % MARK == 0 else z + 1
        bt.block_tridiag_solve(D, O, b)

    call()  # warm-up: the library, the allocator, the profiler's first trace
    _traced(call, WAIT_S, WAIT_S)
    out = {}
    for way in ways:
        head_s, tail_s, serial, warmup = WAYS[way]
        one = lambda: _traced(call, head_s, tail_s, warmup)  # noqa: E731
        traces = [_in_turn(lock_path, one, call) if serial else one() for _ in range(reps)]
        lost = [_losses(k) for k, _ in traces]
        first = [t for _, t in traces if t is not None]
        out[way] = {"traces": reps, "fewest_kernels": min(len(k) for k, _ in traces),
                    "fewest_marks": min(k.count("mark") for k, _ in traces),
                    "most_kernels_lost": max(OPS + 2 - len(k) for k, _ in traces),
                    "first_kernel_ms_least": min(first, default=None),
                    "first_kernel_ms_most": max(first, default=None),
                    **{f"lost_{w}": sum(x[i] for x in lost)
                       for i, w in enumerate(("any", "head", "tail", "middle"))}}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="where torch.profiler loses kernels")
    ap.add_argument("--ways", default="no_wait,wait_after,wait_before_and_after",
                    help=f"comma-separated, of {', '.join(WAYS)}")
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    ways = args.ways.split(",")
    unknown = set(ways) - set(WAYS)
    if unknown:
        ap.error(f"unknown ways {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("trace_tail: needs a CUDA device")
    from ..ops import block_tridiag as bt
    from .eval import card_info

    bt._load_library()  # built once, before the processes load it
    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ProcessPoolExecutor(
            PROCS, mp_context=mp.get_context("spawn")) as pool:
        job = (ways, args.reps, os.path.join(tmp, "trace.lock"))
        runs = list(pool.map(_worker, [job] * PROCS))
    report = {"card": card_info(), "procs": PROCS, "wait_s": WAIT_S,
              "long_wait_s": LONG_WAIT_S, "kernels_per_call": OPS + 2}
    pick = {"fewest": min, "least": min, "most": max}
    for way in ways:
        report[way] = {k: pick.get(next((p for p in pick if p in k), ""), sum)(
            r[way][k] for r in runs if r[way][k] is not None) for k in runs[0][way]}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
