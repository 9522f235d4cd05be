"""How often torch.profiler loses kernels of a traced call, and where.

PROCS processes at once each trace REPS calls of one block-tridiagonal
solve through the warp kernel, OPS small elementwise kernels (about the
kernels of a served tick; calls of 300 lost nothing), every MARK-th of
them a negation that marks its place, and one more solve, in three
ways: the call started as the profiler starts and the profiler stopped
right after its sync; stopped WAIT_S seconds later; and also started
WAIT_S seconds after the profiler (as `chip_smoke.py`'s traces). For
each way it counts the traces that lost kernels: any, the first solve or
the first mark (the head), the last solve or the last mark (the tail), a
mark between them; and the fewest kernels and marks a trace held. Prints
one JSON line. Needs the card.

  python -m deqmpc_tpu_torch.training.trace_tail
"""
from __future__ import annotations

import concurrent.futures
import json
import multiprocessing as mp
import time

import torch

PROCS, REPS, OPS, MARK, WAIT_S = 6, 20, 30000, 500, 0.05


def _traced(fn, head_s, tail_s):
    """The kernels the profiler recorded, each as "warp", "mark" or "op",
    in the order they ran."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops import block_tridiag as bt

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(head_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(tail_s)
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    return ["warp" if bt.KERNEL_FUNCTIONS["warp"] in e.name else
            "mark" if "neg_kernel" in e.name else "op" for e in kernels]


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


def _worker(_):
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
    for way, head_s, tail_s in (("no_wait", 0.0, 0.0), ("wait_after", 0.0, WAIT_S),
                                ("wait_before_and_after", WAIT_S, WAIT_S)):
        traces = [_traced(call, head_s, tail_s) for _ in range(REPS)]
        lost = [_losses(k) for k in traces]
        out[way] = {"traces": REPS, "fewest_kernels": min(len(k) for k in traces),
                    "fewest_marks": min(k.count("mark") for k in traces),
                    **{f"lost_{w}": sum(x[i] for x in lost)
                       for i, w in enumerate(("any", "head", "tail", "middle"))}}
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("trace_tail: needs a CUDA device")
    from ..ops import block_tridiag as bt
    from .eval import card_info

    bt._load_library()  # built once, before the processes load it
    with concurrent.futures.ProcessPoolExecutor(
            PROCS, mp_context=mp.get_context("spawn")) as pool:
        runs = list(pool.map(_worker, range(PROCS)))
    report = {"card": card_info(), "procs": PROCS, "wait_s": WAIT_S,
              "kernels_per_call": OPS + 2}
    for way in runs[0]:
        report[way] = {k: (min if k.startswith("fewest") else sum)(r[way][k] for r in runs)
                       for k in runs[0][way]}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
