#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`deqmpc_tpu_torch`) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each announced on a line of its own with the seconds since start:
  1. device: the card's name and its nvidia-smi name/power-limit line;
  2. build: the block-tridiagonal CUDA kernels (the warp kernel for
     n <= 32, the block kernel for n > 32), compiled from this checkout;
     one line of registers and spills per kernel;
  3. kernel: each kernel against the plain PyTorch version on the card,
     at (bsz, T, n) = (1024,5,16), (128,5,3) (training, config #1),
     (128,10,5), (64,20,18), (4,200,18) (does not fit shared memory),
     (32,5,16) (serving), (128,5,16) (training, config #4), (32,5,3)
     (serving the pendulum) and (8,5,40) (n > 32), in f32 and f64, with
     one non-SPD sample per case that must come back NaN while its
     neighbours stay finite: the kernel the wrapper picks at every shape,
     and the block kernel by name at the shapes the warp kernel takes;
     then, at the five shapes of TIMED_SHAPES, both kernels'
     call time and device time (torch.profiler) beside the plain
     version, the dense-Cholesky library call and the bound;
  4. load: `checkpoints/rexquad_deqmpc` through the port's own reader,
     and the policy at full width;
  5. serve: tick 0's first actions on the card against the same forward
     on the CPU (f32, and f64 for a tight check), with the jittered
     retries of both; every Newton system of the card's tick 0, f32 and
     f64, held against the plain version on the card (same NaN samples,
     the dtype's tolerance where well conditioned); the card's f64
     forward once more with the plain solve in place of the kernel, and
     its gap to the CPU; a planted fault (O transposed in the solve)
     that the tick-0 check must reject; then 32 episodes x 10
     closed-loop ticks through `eval_policy` with the launch counters
     set to 0 just before and read just after: every launch must go
     through the warp kernel;
  6. train, config #4 (RexQuadrotor, full width, from
     `checkpoints/rexquad_deqmpc`): one seeded bsz-128 batch of the expert
     data through the port's pipeline; step 0 on the CPU and on the card,
     in f32 and in f64 (within STEP0_RTOL: the loss in f32, the loss and
     gradient norm in f64; the f32 gradient norm's gap is printed), the
     card's step 0 once more from start states moved by 1e-6 (f32) and
     1e-12 (f64) (its rounding sensitivity) and once with a planted fault
     (the implicit backward's dQ and dq with their signs flipped, f64),
     then 3 steps on the card with the counts set to 0 just before: finite loss
     and gradient norm, every solve through the warp kernel, exactly one
     implicit-backward solve per round (6 a step); the step time split into
     forward, backward and optimizer; one more step under torch.profiler
     for the kernel's device time per step;
  7. train, config #1 (pendulum, a seeded fresh policy at full width,
     bsz 128): 5 steps on one batch; the loss must fall;
  8. serve `checkpoints/pendulum_deqmpc`: 32 episodes x 20 closed-loop
     ticks, no NaN, every solve through the warp kernel at n = 3.
Before them, one `[chip_smoke] report {...}` line holds every number
measured. The last three lines are the nvidia-smi line, the kernels JSON
and {"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""
import dataclasses
import json
import re
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
CKPT = "checkpoints/rexquad_deqmpc"
PENDULUM_CKPT = "checkpoints/pendulum_deqmpc"
EPISODES, TICKS = 32, 10
PENDULUM_EPISODES, PENDULUM_TICKS = 32, 20
TRAIN_BSZ, TRAIN_STEPS, PENDULUM_TRAIN_STEPS = 128, 3, 5
SERVE_SHAPE = (EPISODES, 5, 16)  # the solve's shape on the served path
# the solve's shape in the config-#4 training step, forward and backward:
# this slice's main path, whose numbers the kernels line reports
MAIN_SHAPE = (TRAIN_BSZ, 5, 16)
PENDULUM_SERVE_SHAPE = (PENDULUM_EPISODES, 5, 3)  # the served pendulum's solve
KERNEL_SHAPES = [(1024, 5, 16), (128, 5, 3), (128, 10, 5), (64, 20, 18), (4, 200, 18), SERVE_SHAPE,
                 MAIN_SHAPE, PENDULUM_SERVE_SHAPE, (8, 5, 40)]
TIMED_SHAPES = [(MAIN_SHAPE, torch.float32), (SERVE_SHAPE, torch.float32),
                ((1024, 5, 16), torch.float32), ((128, 5, 3), torch.float32),
                ((64, 20, 18), torch.float64)]
# H100 SXM, NVIDIA data sheet: HBM rate; f32 outside the tensor cores,
# f64 through the tensor cores (DMMA), the fastest each type can run
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
# kernel vs plain version on identical inputs
KERNEL_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
              torch.float64: dict(rtol=1e-8, atol=1e-9)}
# served Newton systems: where a Schur complement has 1/cond below this,
# f32 rounding can turn a pivot's sign; a solve's normwise backward error
# stays within ~T*n*eps = 80 * 6e-8 of 0
BORDERLINE_INV_COND = 1e-5
BACKWARD_ERR = {torch.float32: 1e-5, torch.float64: 1e-12}
# tick-0 first actions, card vs CPU: the median and 75th percentile over
# episodes of the per-episode max |du| (see PERF.md for why quantiles)
ACTION_TOL = {torch.float32: {"median": 5e-2, "p75": 1.0},
              torch.float64: {"median": 1e-4, "p75": 1e-3}}
# config-#4 training step 0, card vs CPU, relative gap. The f32 forward
# turns rounding into moves of single samples (PERF.md: start states moved
# by 1e-6 move first actions by a median of 0.0028 and a max of 2.1); the
# loss averages 128 samples over 6 rounds, so a few moved samples move it
# by about 1%. The f32 gradient norm is no sharper than its own rounding
# sensitivity: on the card, start states moved by 1e-6 moved it by 66%
# (PERF.md), since half of the backward's samples have an indefinite
# Hessian and are zeroed, and which half flips with rounding; so its gap
# is printed with no limit. The f64 step keeps the same configuration
# with no indefinite Hessian to flip: its limits hold the backward, and it
# is the only step-0 check that a fault of the backward can fail
STEP0_RTOL = {torch.float32: {"loss": 2e-2},
              torch.float64: {"loss": 1e-3, "grad_norm": 5e-2}}


def phase(name, **info):
    extra = (" " + json.dumps(info)) if info else ""
    print(f"[chip_smoke] {name} t={time.perf_counter() - T0:.1f}s{extra}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def problem(bsz, T, n, dtype, seed=0, nonspd=None):
    """An SPD block-tridiagonal system made with numpy from a seed; sample
    `nonspd` gets a negative-definite block."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(bsz, T, n, n))
    D = A @ np.swapaxes(A, -1, -2) + 2.0 * np.eye(n) * (T + 1)
    O = 0.3 * rng.normal(size=(bsz, T - 1, n, n))
    b = rng.normal(size=(bsz, T, n))
    if nonspd is not None:
        D[nonspd, T // 2] = -np.eye(n)
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in (D, O, b)]


def cuda_ms(fn, iters):
    """Time per call of back-to-back calls: the wrapper's host work and the
    kernel, whichever is longer."""
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, key, iters=50):
    """The kernel's own device time per launch: torch.profiler's device
    time of the kernels whose name holds `key`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if key in e.key]
    count = sum(e.count for e in events)
    total_us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
                   for e in events)
    check(count > 0 and total_us > 0,
          f"the profiler shows {count} launches of {key} and {total_us} us for {iters} calls")
    return total_us / 1e3 / count


def bound_ms(bsz, T, n, dtype):
    """Least time for the solve: each input read once and x written once at
    the HBM rate, or the factor-and-sweep operations at the peak rate,
    whichever is larger. D is symmetric and only its lower triangle is
    read, so it counts n(n+1)/2 elements a block."""
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = elem * bsz * (T * n * (n + 1) // 2 + (T - 1) * n * n + 2 * T * n)
    # per sample: T Cholesky (n^3/3), T-1 triangular solves with n right-hand
    # sides (n^3) and T-1 products M M' (n^3), two sweeps (3n^2 each per step)
    flops = bsz * (T * n**3 / 3 + (T - 1) * 2 * n**3 + T * 6 * n**2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_solve(bt, tridiag, bsz, T, n, dtype):
    """Both kernels at one shape, in turns (warp, block, block, warp), beside
    the plain version, the library call and the bound."""
    D, O, b = problem(bsz, T, n, dtype, seed=1)
    H = tridiag.block_tridiag_dense(D, O)
    bcol = b.reshape(bsz, T * n, 1)

    def library():
        L = torch.linalg.cholesky(H)
        y = torch.linalg.solve_triangular(L, bcol, upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)

    bnd, by = bound_ms(bsz, T, n, dtype)
    row = {"shape": [bsz, T, n], "dtype": str(dtype).replace("torch.", ""),
           "plain_ms": cuda_ms(lambda: tridiag.block_tridiag_solve(D, O, b), 20),
           "library_ms": cuda_ms(library, 20), "bound_ms": bnd, "bound_by": by}
    for kernel in ("warp", "block", "block", "warp"):
        call = lambda: bt.block_tridiag_solve(D, O, b, kernel=kernel)  # noqa: E731
        ms = cuda_ms(call, 200)
        dev = device_ms(call, bt.KERNEL_FUNCTIONS[kernel])
        row.setdefault(f"{kernel}_ms", []).append(ms)
        row.setdefault(f"{kernel}_device_ms", []).append(dev)
    for key in ("warp_ms", "warp_device_ms", "block_ms", "block_device_ms"):
        row[key] = min(row[key])
    row["speedup_device"] = row["block_device_ms"] / row["warp_device_ms"]
    return row


def ptxas_summary(text):
    """One line per kernel from nvcc -Xptxas -v: registers and spills."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(bt_warp_kernel|block_tridiag_solve_kernel)I([fd])(?:Li(\d+)E)?",
                          m.group(1))
            name = f"{k.group(1)}<{k.group(2)}{', ' + k.group(3) if k.group(3) else ''}>" \
                if k else m.group(1)
        elif name and ("spill" in line or "registers" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


def dev_us(e):
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)


def reset_counts(bt):
    bt.block_tridiag_solve.launches = 0
    bt.block_tridiag_solve.launches_by_kernel = dict.fromkeys(bt.KERNELS, 0)


def path_counts(bt, policy, before):
    """Launches by kernel, Newton steps, retries and backward solves since
    `before` (a dict of the policy's counts taken at the start)."""
    return {"launches": bt.block_tridiag_solve.launches,
            "launches_by_kernel": dict(bt.block_tridiag_solve.launches_by_kernel),
            "newton_steps": policy.newton_steps - before["newton_steps"],
            "retries": policy.newton_retries - before["retries"],
            "backward_solves": policy.backward_solves - before["backward_solves"]}


def policy_counts(policy):
    return {"newton_steps": policy.newton_steps, "retries": policy.newton_retries,
            "backward_solves": policy.backward_solves}


def check_all_warp(counts, what):
    by = counts["launches_by_kernel"]
    check(counts["launches"] > 0 and by["warp"] == counts["launches"] and by["block"] == 0,
          f"{what}: not every solve went through the warp kernel: {by}")
    solves = counts["newton_steps"] + counts["retries"] + counts["backward_solves"]
    check(counts["launches"] == solves,
          f"{what}: {counts['launches']} launches for {solves} solves ({counts})")


def rel_gap(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def train_rexquad(bt, train, build_policy, DEQMPCPolicy, newton_al, state, args, env, batch_np):
    """Config #4's training step: step 0 on the card against the CPU, in
    f32 (the trained configuration) and f64 (tight), each beside the card's
    own move under a perturbation of the start states; then TRAIN_STEPS
    steps on the card (the main path) and one profiled step."""
    def fresh(dev, dtype=torch.float32):
        p = build_policy(args, env, dev)
        if dtype == torch.float64:
            p = DEQMPCPolicy(dataclasses.replace(p.cfg, solver_dtype=dtype), env, dev)
            p.model.double()
        p.model.load_state_dict({k: v.to(dev) for k, v in state.items()})
        return p, train.make_optimizer(p)

    def step0(dev, dtype, rel_noise=0.0):
        b = dict(batch_np)
        noise = np.random.default_rng(1).normal(size=b["obs"].shape)
        b["obs"] = b["obs"].astype(np.float64) * (1 + rel_noise * noise)
        p, o = fresh(dev, dtype)
        t = time.perf_counter()
        res = train.train_step(p, o, train.to_device(b, dev, dtype))
        return {"loss": float(res["loss"]), "grad_norm": float(res["grad_norm"]),
                "s": time.perf_counter() - t}

    def gaps(a, b):
        return {k: rel_gap(a[k], b[k]) for k in ("loss", "grad_norm")}

    out = {"cpu_step0": step0("cpu", torch.float32),
           "card_step0_moved_1e-6": step0("cuda", torch.float32, 1e-6),
           "cpu_step0_f64": step0("cpu", torch.float64),
           "card_step0_f64": step0("cuda", torch.float64),
           "card_step0_f64_moved_1e-12": step0("cuda", torch.float64, 1e-12)}
    out["step0_gap_card_vs_cpu_f64"] = gaps(out["card_step0_f64"], out["cpu_step0_f64"])
    out["step0_gap_sensitivity_f64_1e-12"] = gaps(out["card_step0_f64_moved_1e-12"],
                                                  out["card_step0_f64"])
    # a planted fault the f64 check should see: the implicit backward's
    # gradients into Q and q with their signs flipped
    good = newton_al.implicit_grads
    newton_al.implicit_grads = lambda *a: (lambda dQ, dq, z: (-dQ, -dq, z))(*good(*a))
    try:
        out["card_step0_f64_planted_sign_flip"] = step0("cuda", torch.float64)
    finally:
        newton_al.implicit_grads = good
    out["step0_gap_planted_sign_flip_f64"] = gaps(out["card_step0_f64_planted_sign_flip"],
                                                  out["cpu_step0_f64"])

    policy, opt = fresh("cuda")
    batch = train.to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    before = policy_counts(policy)
    reset_counts(bt)
    steps = []
    for _ in range(TRAIN_STEPS):
        c0, by0 = policy_counts(policy), dict(bt.block_tridiag_solve.launches_by_kernel)
        timings = {}
        t = time.perf_counter()
        res = train.train_step(policy, opt, batch, timings=timings)
        step_s = time.perf_counter() - t  # train_step synchronised the card
        c1 = policy_counts(policy)
        steps.append({"loss": float(res["loss"]), "grad_norm": float(res["grad_norm"]),
                      "step_s": step_s, **timings,
                      **{k: c1[k] - c0[k] for k in c1},
                      "launches_by_kernel": {k: bt.block_tridiag_solve.launches_by_kernel[k] - by0[k]
                                             for k in bt.KERNELS}})
    out["counts"] = path_counts(bt, policy, before)
    out["deq_iter"] = policy.cfg.deq_iter
    out["backward_zeroed_share"] = policy.backward_zeroed_share()
    out["steps"] = steps
    out["card_step0"] = {k: steps[0][k] for k in ("loss", "grad_norm")}
    out["step0_gap_card_vs_cpu"] = gaps(out["card_step0"], out["cpu_step0"])
    out["step0_gap_sensitivity_1e-6"] = gaps(out["card_step0_moved_1e-6"], out["card_step0"])
    step_s = float(np.median([s["step_s"] for s in steps]))
    out["step_s_median"] = step_s
    for part in ("forward_s", "backward_s", "optimizer_s"):
        out[f"{part}_median"] = float(np.median([s[part] for s in steps]))
    out["backward_share"] = out["backward_s_median"] / step_s

    # one more step under the profiler: the kernel's device time per step
    # (device activity only: host events of ~100k ops take minutes to sum)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        train.train_step(policy, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in kernels)
    solve = [e for e in kernels if bt.KERNEL_FUNCTIONS["warp"] in e.key]
    out["profiled_step"] = {
        "wall_s": wall, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches": sum(e.count for e in kernels),
        "warp_kernel_launches": sum(e.count for e in solve),
        "warp_kernel_device_ms": sum(dev_us(e) for e in solve) / 1e3}
    return out


def train_pendulum(bt, train, build_policy, env, batch_np):
    """Config #1: a seeded fresh policy at full width, PENDULUM_TRAIN_STEPS
    steps on one batch."""
    args = vars(train.parse_args(["--env", "pendulum", "--model_type", "deq-mpc-deq", "--T", "5",
                                  "--deq_iter", "6", "--hdim", "256", "--bsz", str(TRAIN_BSZ)]))
    policy = build_policy(args, env, "cuda").init(0)
    opt = train.make_optimizer(policy)
    batch = train.to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    before = policy_counts(policy)
    reset_counts(bt)
    losses, norms, step_s = [], [], []
    for _ in range(PENDULUM_TRAIN_STEPS):
        timings = {}
        res = train.train_step(policy, opt, batch, timings=timings)
        losses.append(float(res["loss"]))
        norms.append(float(res["grad_norm"]))
        step_s.append(sum(timings.values()))
    return {"losses": losses, "grad_norms": norms, "step_s": step_s,
            "backward_zeroed_share": policy.backward_zeroed_share(),
            "hdim": policy.cfg.hdim, "deq_iter": policy.cfg.deq_iter,
            "counts": path_counts(bt, policy, before)}


def serve_pendulum(bt, newton_al, build_policy, load_checkpoint, make_env, eval_policy):
    """`pendulum_deqmpc` in closed loop, recording the block size of every
    solve."""
    state, args = load_checkpoint(PENDULUM_CKPT, "cuda")
    env = make_env(args["env"])
    policy = build_policy(args, env, "cuda")
    policy.model.load_state_dict(state)
    sizes, solve = set(), newton_al.block_tridiag_solve
    newton_al.block_tridiag_solve = lambda D, O, b: (sizes.add(D.shape[-1]), solve(D, O, b))[1]
    before = policy_counts(policy)
    reset_counts(bt)
    try:
        res = eval_policy(args, env, policy, n_episodes=PENDULUM_EPISODES, ep_len=PENDULUM_TICKS,
                          seed=0, device="cuda")
    finally:
        newton_al.block_tridiag_solve = solve
    res["counts"] = path_counts(bt, policy, before)
    res["block_sizes"] = sorted(sizes)
    return res


def action_gap(u_card, u_cpu):
    gap = (u_card.double().cpu() - u_cpu.double()).abs().amax(dim=-1)
    return {"median": float(gap.median()), "p75": float(gap.quantile(0.75)),
            "max": float(gap.max())}


def gap_within(gap, dtype):
    return all(gap[q] <= lim for q, lim in ACTION_TOL[dtype].items())


def min_inv_cond(D, O):
    """Per sample, the least 1/cond over the Schur complements
    S_t = D_t - O_{t-1}' S_{t-1}^{-1} O_{t-1}, in f64 and from the lower
    triangles the solves read. Near 0 means a pivot that rounding can turn
    either way, and a solution that rounding can move far."""
    D, O = D.double(), O.double()
    sym = lambda A: A.tril() + A.tril(-1).mT  # noqa: E731
    out, S = [], None
    for t in range(D.shape[1]):
        S = sym(D[:, t]) if t == 0 else sym(D[:, t]) - O[:, t - 1].mT @ torch.linalg.solve_ex(
            S, O[:, t - 1])[0]
        ev = torch.linalg.eigvalsh(S).abs()
        out.append(ev.amin(dim=-1) / ev.amax(dim=-1))
    return torch.stack(out, dim=1).amin(dim=1)


def backward_error(tridiag, D, O, x, b):
    """Per sample ||H x - b|| / (||H|| ||x|| + ||b||), in f64."""
    D, O, x, b = D.double(), O.double(), x.double(), b.double()
    D = D.tril() + D.tril(-1).mT
    r = tridiag.block_tridiag_matvec(D, O, x) - b
    nH = torch.linalg.matrix_norm(tridiag.block_tridiag_dense(D, O))
    return r.flatten(1).norm(dim=1) / (nH * x.flatten(1).norm(dim=1) + b.flatten(1).norm(dim=1))


def check_served_systems(bt, tridiag, systems, dtype):
    """Every Newton system (g, D, O) of a served forward in `dtype`, the
    kernel against the plain version on the card. Most of them are
    indefinite or nearly singular (rho up to 1e5), so: the two give NaN on
    the same samples except where a pivot is within rounding of 0; every
    finite kernel result has a backward error at the dtype's rounding
    level; and where the system is well conditioned the two agree within
    the dtype's tolerance."""
    st = {"dtype": str(dtype), "systems": len(systems), "samples": 0, "nan_kernel": 0,
          "nan_plain": 0,
          "nan_f64": 0, "nan_plain_and_f64": 0,
          "nan_mismatch": 0, "nan_mismatch_inv_cond_max": 0.0, "retry_mismatch": 0,
          "well_conditioned": 0, "max_abs_err_well_conditioned": 0.0,
          "max_abs_err_finite": 0.0, "backward_err_kernel_max": 0.0,
          "backward_err_plain_max": 0.0}
    failures = []
    for i, (g, D, O) in enumerate(systems):
        x = bt.block_tridiag_solve(D, O, g)
        x_ref = tridiag.block_tridiag_solve(D, O, g)
        nan, nan_ref = (torch.isnan(v).flatten(1).any(dim=1) for v in (x, x_ref))
        r = min_inv_cond(D, O)
        # the same f32 inputs solved in f64: NaN there means truly indefinite
        nan64 = torch.isnan(tridiag.block_tridiag_solve(D.double(), O.double(), g.double())
                            ).flatten(1).any(dim=1)
        st["nan_f64"] += int(nan64.sum())
        st["nan_plain_and_f64"] += int((nan_ref & nan64).sum())
        st["samples"] += nan.numel()
        st["nan_kernel"] += int(nan.sum())
        st["nan_plain"] += int(nan_ref.sum())
        diff = nan != nan_ref
        st["nan_mismatch"] += int(diff.sum())
        if bool(diff.any()):
            st["nan_mismatch_inv_cond_max"] = max(st["nan_mismatch_inv_cond_max"],
                                                       float(r[diff].max()))
        st["retry_mismatch"] += int(bool(nan.any()) != bool(nan_ref.any()))
        both = ~(nan | nan_ref)
        if bool(both.any()):
            st["max_abs_err_finite"] = max(st["max_abs_err_finite"],
                                           float((x[both] - x_ref[both]).abs().max()))
        for key, v, m in (("backward_err_kernel_max", x, ~nan), ("backward_err_plain_max", x_ref, ~nan_ref)):
            if bool(m.any()):
                st[key] = max(st[key], float(backward_error(tridiag, D[m], O[m], v[m], g[m]).max()))
        well = both & (r > 1e-3)
        st["well_conditioned"] += int(well.sum())
        if bool(well.any()):
            st["max_abs_err_well_conditioned"] = max(st["max_abs_err_well_conditioned"],
                                                     float((x[well] - x_ref[well]).abs().max()))
            try:
                torch.testing.assert_close(x[well], x_ref[well], **KERNEL_TOL[dtype])
            except AssertionError as e:
                failures.append(f"system {i}: {e}")
    print(f"[chip_smoke]   served Newton systems, kernel vs plain: {json.dumps(st)}", flush=True)
    check(st["nan_mismatch_inv_cond_max"] < BORDERLINE_INV_COND,
          "kernel and plain version disagree on NaN where no pivot is near 0")
    check(st["backward_err_kernel_max"] <= BACKWARD_ERR[dtype],
          f"kernel backward error {st['backward_err_kernel_max']} > {BACKWARD_ERR[dtype]}")
    check(not failures, "\n".join(failures))
    return st


def main() -> int:
    # -- 1. device ----------------------------------------------------------
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 1
    from deqmpc_tpu_torch.data import get_gt_data, sample_trajectory
    from deqmpc_tpu_torch.envs import make_env
    from deqmpc_tpu_torch.ops import block_tridiag as bt
    from deqmpc_tpu_torch.ops import tridiag
    from deqmpc_tpu_torch.policies import DEQMPCPolicy, build_policy
    from deqmpc_tpu_torch.solvers import newton_al
    from deqmpc_tpu_torch.training import train
    from deqmpc_tpu_torch.training.eval import card_info, eval_policy
    from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint

    smi = card_info()["nvidia_smi"]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[chip_smoke] nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, numpy {np.__version__}", flush=True)
    report = {"device": {"kind": kind, "count": count, "nvidia_smi": smi,
                         "torch": torch.__version__, "cuda": torch.version.cuda,
                         "numpy": np.__version__}}

    # -- 2. build -----------------------------------------------------------
    phase("build")
    t = time.perf_counter()
    ptxas = bt.build()
    bt._load_library()
    report["build_s"] = time.perf_counter() - t
    report["ptxas"] = ptxas_summary(ptxas)
    for name, line in report["ptxas"].items():
        print(f"[chip_smoke]   ptxas {name}: {line}", flush=True)
    phase("build done", seconds=report["build_s"])

    # -- 3. kernels vs plain version -----------------------------------------
    phase("kernel")
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for bsz, T, n in KERNEL_SHAPES:
            D, O, b = problem(bsz, T, n, dtype, nonspd=1)
            x_ref = tridiag.block_tridiag_solve(D, O, b)
            check(bool(torch.isnan(x_ref[1]).all()), f"plain: non-SPD sample not NaN at {(bsz, T, n)}")
            keep = torch.ones(bsz, dtype=torch.bool, device="cuda")
            keep[1] = False
            for kernel in dict.fromkeys([bt.pick_kernel(n), "block"]):
                x = bt.block_tridiag_solve(D, O, b, kernel=kernel)
                torch.cuda.synchronize()
                where = f"{kernel} kernel at {(bsz, T, n)} {dtype}"
                check(bool(torch.isnan(x[1]).all()), f"non-SPD sample not NaN: {where}")
                check(bool(torch.isfinite(x[keep]).all()), f"finite samples broke: {where}")
                torch.testing.assert_close(x[keep], x_ref[keep], **KERNEL_TOL[dtype])
                err = float((x[keep] - x_ref[keep]).abs().max())
                worst[f"{kernel}/{bsz}x{T}x{n}/{dtype}"] = err
                print(f"[chip_smoke]   {where}: max|kernel-plain| = {err:.3e}", flush=True)
    report["kernel_max_abs_err"] = worst
    timings = [time_solve(bt, tridiag, *shape, dtype) for shape, dtype in TIMED_SHAPES]
    report["kernel_timings"] = timings
    for row in timings:
        print(f"[chip_smoke]   timing {json.dumps(row)}", flush=True)

    # -- 4. load ------------------------------------------------------------
    phase("load")
    state, args = load_checkpoint(CKPT, "cuda")
    env = make_env(args["env"])
    policy = build_policy(args, env, "cuda")
    policy.model.load_state_dict(state)
    n_params = sum(p.numel() for p in policy.model.parameters())
    phase("load done", params=n_params, hdim=policy.cfg.hdim, deq_iter=policy.cfg.deq_iter)

    # -- 5. serve -------------------------------------------------------------
    phase("serve: tick 0 on the card vs the CPU")
    x0 = env.reset(torch.Generator().manual_seed(0), EPISODES, device="cpu")
    gaps, retries, systems = {}, {}, {}

    def first_actions(p, x):
        return p.forward(x)["trajs"][-1][2][:, 0]

    with torch.inference_mode():
        for dtype in (torch.float32, torch.float64):
            pols = {}
            for dev in ("cuda", "cpu"):
                cfg = dataclasses.replace(policy.cfg, solver_dtype=dtype)
                p = DEQMPCPolicy(cfg, env, dev)
                p.model.load_state_dict(state)
                p.model.to(dtype)
                pols[dev] = p
            newton = pols["cuda"].tracking_mpc.ctrl.newton
            # keep every Newton system the card solves in this forward
            solve, kept = newton._solve_newton_system, systems.setdefault(dtype, [])
            newton._solve_newton_system = lambda g, D, O: (
                kept.append((g.clone(), D.clone(), O.clone())), solve(g, D, O))[1]
            u = {dev: first_actions(pols[dev], x0.to(dev, dtype)) for dev in ("cuda", "cpu")}
            newton.__dict__.pop("_solve_newton_system", None)
            check(bool(torch.isfinite(u["cuda"]).all()), f"non-finite action on the card ({dtype})")
            retries[str(dtype)] = {dev: {"newton_steps": p.newton_steps,
                                         "retries": p.newton_retries}
                                   for dev, p in pols.items()}
            gaps[str(dtype)] = g = action_gap(u["cuda"], u["cpu"])
            print(f"[chip_smoke]   {dtype}: tick-0 action gap {json.dumps(g)}, "
                  f"retries {json.dumps(retries[str(dtype)])}", flush=True)
            if dtype == torch.float32:
                # a planted fault: the solve sees O transposed; the gap check
                # must reject it
                good_solve = newton_al.block_tridiag_solve
                newton_al.block_tridiag_solve = lambda D, O, b: good_solve(
                    D, O.mT.contiguous(), b)
                u_bad = first_actions(pols["cuda"], x0.to("cuda", dtype))
                newton_al.block_tridiag_solve = good_solve
                gaps["planted_fault_O_transposed"] = g_bad = action_gap(u_bad, u["cpu"])
                print(f"[chip_smoke]   planted fault: tick-0 action gap {json.dumps(g_bad)}",
                      flush=True)
            else:
                # the same f64 forward on the card with the plain solve in
                # place of the kernel: does the card-vs-CPU gap come from it?
                good_solve = newton_al.block_tridiag_solve
                newton_al.block_tridiag_solve = tridiag.block_tridiag_solve
                u_plain = first_actions(pols["cuda"], x0.to("cuda", dtype))
                newton_al.block_tridiag_solve = good_solve
                gaps["f64_plain_solve_on_card"] = action_gap(u_plain, u["cpu"])
                gaps["f64_kernel_vs_plain_solve_on_card"] = action_gap(u["cuda"], u_plain.cpu())
                print("[chip_smoke]   f64 with the plain solve on the card: gap to the CPU "
                      f"{json.dumps(gaps['f64_plain_solve_on_card'])}, to the kernel "
                      f"{json.dumps(gaps['f64_kernel_vs_plain_solve_on_card'])}", flush=True)
        # f32 rounding sensitivity of the same forward on the card
        noise = 1e-6 * torch.randn(x0.shape, generator=torch.Generator().manual_seed(1))
        u_a = first_actions(policy, x0.cuda())
        u_b = first_actions(policy, (x0 * (1 + noise)).cuda())
        gaps["f32_sensitivity_1e-6"] = action_gap(u_a, u_b.cpu())
        print(f"[chip_smoke]   f32 sensitivity to 1e-6: {json.dumps(gaps['f32_sensitivity_1e-6'])}",
              flush=True)
    report["tick0_action_gap"] = gaps
    report["tick0_retries"] = retries
    report["served_systems"] = [check_served_systems(bt, tridiag, systems[dtype], dtype)
                                for dtype in (torch.float32, torch.float64)]
    for dtype in (torch.float32, torch.float64):
        check(gap_within(gaps[str(dtype)], dtype),
              f"tick-0 actions, card vs CPU ({dtype}): {gaps[str(dtype)]} "
              f"beyond {ACTION_TOL[dtype]}")
    check(not gap_within(gaps["planted_fault_O_transposed"], torch.float32),
          "the tick-0 check passed a planted fault (O transposed)")

    phase("serve: closed loop", episodes=EPISODES, ticks=TICKS)
    reset_counts(bt)
    steps0 = policy.newton_steps
    res = eval_policy(args, env, policy, n_episodes=EPISODES, ep_len=TICKS, seed=0,
                      device="cuda")
    launches = bt.block_tridiag_solve.launches
    by_kernel = dict(bt.block_tridiag_solve.launches_by_kernel)
    newton_steps = policy.newton_steps - steps0
    res.update(launches=launches, launches_by_kernel=by_kernel, newton_steps=newton_steps,
               launches_per_tick=launches / TICKS)
    report["serve"] = res
    phase("serve done", **res)
    check(res["n_nan_episodes"] == 0, "non-finite states in the closed loop")
    check(np.isfinite(res["mean_reward"]), "non-finite reward")
    check(newton_steps > 0 and launches >= newton_steps,
          f"{launches} kernel launches for {newton_steps} Newton steps")
    check(by_kernel["warp"] == launches and by_kernel["block"] == 0,
          f"the served path did not go through the warp kernel alone: {by_kernel}")

    # -- 6. train, config #4 ----------------------------------------------------
    phase("train: config #4", bsz=TRAIN_BSZ, steps=TRAIN_STEPS)

    def expert_batch(env_name, env_, seed):
        gt, _ = train.split_episodes(get_gt_data(env_))
        return train.preprocess_batch(env_name, env_.nx,
                                      sample_trajectory(gt, TRAIN_BSZ, 1, args["T"],
                                                        np.random.default_rng(seed)))

    tr4 = train_rexquad(bt, train, build_policy, DEQMPCPolicy, newton_al, state, args, env,
                        expert_batch(args["env"], env, 0))
    report["train_rexquad"] = tr4
    for s_ in tr4["steps"]:
        print(f"[chip_smoke]   step {json.dumps(s_)}", flush=True)
    phase("train: config #4 done", **{k: v for k, v in tr4.items() if k != "steps"})
    for i, s_ in enumerate(tr4["steps"]):
        check(np.isfinite(s_["loss"]) and np.isfinite(s_["grad_norm"]),
              f"step {i}: loss {s_['loss']}, grad norm {s_['grad_norm']}")
        check(s_["backward_solves"] == tr4["deq_iter"]
              and s_["launches_by_kernel"]["warp"] == s_["newton_steps"] + s_["retries"]
              + s_["backward_solves"] and s_["launches_by_kernel"]["block"] == 0,
              f"step {i}: solves and launches disagree: {s_}")
    check_all_warp(tr4["counts"], "config-#4 training")
    check(tr4["counts"]["backward_solves"] == TRAIN_STEPS * tr4["deq_iter"],
          f"{tr4['counts']['backward_solves']} backward solves in {TRAIN_STEPS} steps")
    for dtype, key in ((torch.float32, "step0_gap_card_vs_cpu"),
                       (torch.float64, "step0_gap_card_vs_cpu_f64")):
        for k, lim in STEP0_RTOL[dtype].items():
            check(tr4[key][k] <= lim,
                  f"step 0 {k} ({dtype}), card vs CPU: relative gap {tr4[key][k]} > {lim}")
    check(tr4["step0_gap_planted_sign_flip_f64"]["grad_norm"]
          > STEP0_RTOL[torch.float64]["grad_norm"],
          f"the f64 step-0 check passed a planted fault: {tr4['step0_gap_planted_sign_flip_f64']}")

    # -- 7. train, config #1 ----------------------------------------------------
    phase("train: config #1", bsz=TRAIN_BSZ, steps=PENDULUM_TRAIN_STEPS)
    penv = make_env("pendulum")
    tr1 = train_pendulum(bt, train, build_policy, penv, expert_batch("pendulum", penv, 1))
    report["train_pendulum"] = tr1
    phase("train: config #1 done", **tr1)
    check(all(np.isfinite(tr1["losses"])) and all(np.isfinite(tr1["grad_norms"])),
          f"non-finite loss or gradient norm: {tr1}")
    check(tr1["losses"][-1] < tr1["losses"][0], f"the loss did not fall: {tr1['losses']}")
    check_all_warp(tr1["counts"], "config-#1 training")
    check(tr1["counts"]["backward_solves"] == PENDULUM_TRAIN_STEPS * tr1["deq_iter"],
          f"{tr1['counts']['backward_solves']} backward solves in {PENDULUM_TRAIN_STEPS} steps")

    # -- 8. serve pendulum_deqmpc -------------------------------------------------
    phase("serve: pendulum closed loop", episodes=PENDULUM_EPISODES, ticks=PENDULUM_TICKS)
    sp = serve_pendulum(bt, newton_al, build_policy, load_checkpoint, make_env, eval_policy)
    report["serve_pendulum"] = sp
    phase("serve: pendulum done", **sp)
    check(sp["n_nan_episodes"] == 0 and np.isfinite(sp["mean_reward"]),
          "non-finite states or rewards in the pendulum closed loop")
    check(sp["block_sizes"] == [3], f"pendulum solves at block sizes {sp['block_sizes']}")
    check_all_warp(sp["counts"], "pendulum closed loop")

    # -- 9. result ------------------------------------------------------------
    main_t = timings[0]
    paths = {"train_rexquad": tr4["counts"], "train_pendulum": tr1["counts"],
             "serve_rexquad": {"launches_by_kernel": by_kernel},
             "serve_pendulum": sp["counts"]}
    kernels = [{
        "name": f"block_tridiag_solve[{kernel}]", "route": "cuda",
        "source": "deqmpc_tpu_torch/ops/csrc/block_tridiag.cu",
        "replaces": "deqmpc_tpu/ops/pallas_tridiag.py:100",
        "launches": tr4["counts"]["launches_by_kernel"][kernel],
        "launches_by_path": {k: v["launches_by_kernel"][kernel] for k, v in paths.items()},
        "max_abs_err": worst[f"{kernel}/{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}x{MAIN_SHAPE[2]}/torch.float32"],
        "ms": main_t[f"{kernel}_ms"], "device_ms": main_t[f"{kernel}_device_ms"],
        "device_ms_by_shape": {f"{r['shape']}/{r['dtype']}": r[f"{kernel}_device_ms"]
                               for r in timings},
        "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"], "library_ms": main_t["library_ms"],
    } for kernel in bt.KERNELS]
    report["wall_s"] = time.perf_counter() - T0
    print(f"[chip_smoke] report {json.dumps(report)}", flush=True)
    phase("done")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
