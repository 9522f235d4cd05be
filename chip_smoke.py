#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`deqmpc_tpu_torch`) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each announced on a line of its own with the seconds since start:
  1. device: the card's name and its nvidia-smi name/power-limit line;
  2. build: the block-tridiagonal CUDA kernel, compiled from this checkout;
  3. kernel: the kernel against its plain PyTorch version on the card, at
     (bsz, T, n) = (1024,5,16), (128,5,3), (128,10,5), (64,20,18) and
     (4,200,18) (the last does not fit shared memory), in f32 and f64,
     with one non-SPD sample per case that must come back NaN while its
     neighbours stay finite; then the kernel's time beside the plain
     version, the dense-Cholesky library call and the bound;
  4. load: `checkpoints/rexquad_deqmpc` through the port's own reader,
     and the policy at full width;
  5. serve: tick 0's first actions on the card against the same forward
     on the CPU (f32, and f64 for a tight check), with the jittered
     retries of both; every Newton system of the card's f32 tick 0 held
     against the plain version on the card (same NaN samples, f32
     tolerance on the rest); a planted fault (O transposed in the solve)
     that the tick-0 check must reject; then 32 episodes x 10
     closed-loop ticks through `eval_policy` with the launch counter
     set to 0 just before and read just after.
Before them, one `[chip_smoke] report {...}` line holds every number
measured. The last three lines are the nvidia-smi line, the kernels JSON
and {"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""
import json
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
CKPT = "checkpoints/rexquad_deqmpc"
EPISODES, TICKS = 32, 10
MAIN_SHAPE = (EPISODES, 5, 16)  # the solve's shape on the served path
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
BORDERLINE_INV_COND, BACKWARD_ERR_F32 = 1e-5, 1e-5
# tick-0 first actions, card vs CPU: the median and 75th percentile over
# episodes of the per-episode max |du| (see PERF.md for why quantiles)
ACTION_TOL = {torch.float32: {"median": 5e-2, "p75": 1.0},
              torch.float64: {"median": 1e-4, "p75": 1e-3}}


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
    D, O, b = problem(bsz, T, n, dtype, seed=1)
    H = tridiag.block_tridiag_dense(D, O)
    bcol = b.reshape(bsz, T * n, 1)

    def library():
        L = torch.linalg.cholesky(H)
        y = torch.linalg.solve_triangular(L, bcol, upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)

    bnd, by = bound_ms(bsz, T, n, dtype)
    return {"shape": [bsz, T, n], "dtype": str(dtype).replace("torch.", ""),
            "ms": cuda_ms(lambda: bt.block_tridiag_solve(D, O, b), 200),
            "plain_ms": cuda_ms(lambda: tridiag.block_tridiag_solve(D, O, b), 20),
            "library_ms": cuda_ms(library, 20), "bound_ms": bnd, "bound_by": by}


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


def check_served_systems(bt, tridiag, systems):
    """Every Newton system (g, D, O) of a served forward, the kernel against
    the plain version on the card. Most of them are indefinite or nearly
    singular (rho up to 1e5 in f32), so: the two give NaN on the same
    samples except where a pivot is within rounding of 0; every finite
    kernel result has a backward error at f32 rounding level; and where
    the system is well conditioned the two agree within the f32 tolerance."""
    st = {"systems": len(systems), "samples": 0, "nan_kernel": 0, "nan_plain": 0,
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
                torch.testing.assert_close(x[well], x_ref[well], **KERNEL_TOL[torch.float32])
            except AssertionError as e:
                failures.append(f"system {i}: {e}")
    print(f"[chip_smoke]   served Newton systems, kernel vs plain: {json.dumps(st)}", flush=True)
    check(st["nan_mismatch_inv_cond_max"] < BORDERLINE_INV_COND,
          "kernel and plain version disagree on NaN where no pivot is near 0")
    check(st["backward_err_kernel_max"] <= BACKWARD_ERR_F32,
          f"kernel backward error {st['backward_err_kernel_max']} > {BACKWARD_ERR_F32}")
    check(not failures, "\n".join(failures))
    return st


def main() -> int:
    # -- 1. device ----------------------------------------------------------
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 1
    import dataclasses

    from deqmpc_tpu_torch.envs import make_env
    from deqmpc_tpu_torch.ops import block_tridiag as bt
    from deqmpc_tpu_torch.ops import tridiag
    from deqmpc_tpu_torch.policies import DEQMPCPolicy, build_policy
    from deqmpc_tpu_torch.solvers import newton_al
    from deqmpc_tpu_torch.training.eval import card_info, eval_policy
    from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint

    smi = card_info()["nvidia_smi"]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[chip_smoke] nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    report = {"device": {"kind": kind, "count": count, "nvidia_smi": smi,
                         "torch": torch.__version__, "cuda": torch.version.cuda}}

    # -- 2. build -----------------------------------------------------------
    phase("build")
    t = time.perf_counter()
    ptxas = bt.build()
    bt._load_library()
    report["build_s"] = time.perf_counter() - t
    print(ptxas.strip(), flush=True)
    phase("build done", seconds=report["build_s"])

    # -- 3. kernel vs plain version ------------------------------------------
    phase("kernel")
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for bsz, T, n in [(1024, 5, 16), (128, 5, 3), (128, 10, 5), (64, 20, 18),
                          (4, 200, 18), MAIN_SHAPE]:
            D, O, b = problem(bsz, T, n, dtype, nonspd=1)
            x = bt.block_tridiag_solve(D, O, b)
            torch.cuda.synchronize()
            x_ref = tridiag.block_tridiag_solve(D, O, b)
            check(bool(torch.isnan(x[1]).all()) and bool(torch.isnan(x_ref[1]).all()),
                  f"non-SPD sample not NaN at {(bsz, T, n)} {dtype}")
            keep = torch.ones(bsz, dtype=torch.bool, device="cuda")
            keep[1] = False
            check(bool(torch.isfinite(x[keep]).all()), f"finite samples broke at {(bsz, T, n)}")
            torch.testing.assert_close(x[keep], x_ref[keep], **KERNEL_TOL[dtype])
            err = float((x[keep] - x_ref[keep]).abs().max())
            worst[f"{bsz}x{T}x{n}/{dtype}"] = err
            print(f"[chip_smoke]   {(bsz, T, n)} {dtype}: max|kernel-plain| = {err:.3e}",
                  flush=True)
    report["kernel_max_abs_err"] = worst
    timings = [time_solve(bt, tridiag, *shape, torch.float32)
               for shape in [MAIN_SHAPE, (1024, 5, 16), (128, 5, 3)]]
    timings.append(time_solve(bt, tridiag, 64, 20, 18, torch.float64))
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
    gaps, retries, systems = {}, {}, []

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
            if dtype == torch.float32:
                # keep every Newton system the card solves in this forward
                solve = newton._solve_newton_system
                newton._solve_newton_system = lambda g, D, O: (
                    systems.append((g.clone(), D.clone(), O.clone())), solve(g, D, O))[1]
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
        # f32 rounding sensitivity of the same forward on the card
        noise = 1e-6 * torch.randn(x0.shape, generator=torch.Generator().manual_seed(1))
        u_a = first_actions(policy, x0.cuda())
        u_b = first_actions(policy, (x0 * (1 + noise)).cuda())
        gaps["f32_sensitivity_1e-6"] = action_gap(u_a, u_b.cpu())
        print(f"[chip_smoke]   f32 sensitivity to 1e-6: {json.dumps(gaps['f32_sensitivity_1e-6'])}",
              flush=True)
    report["tick0_action_gap"] = gaps
    report["tick0_retries"] = retries
    report["served_systems"] = check_served_systems(bt, tridiag, systems)
    for dtype in (torch.float32, torch.float64):
        check(gap_within(gaps[str(dtype)], dtype),
              f"tick-0 actions, card vs CPU ({dtype}): {gaps[str(dtype)]} "
              f"beyond {ACTION_TOL[dtype]}")
    check(not gap_within(gaps["planted_fault_O_transposed"], torch.float32),
          "the tick-0 check passed a planted fault (O transposed)")

    phase("serve: closed loop", episodes=EPISODES, ticks=TICKS)
    bt.block_tridiag_solve.launches = 0
    steps0 = policy.newton_steps
    res = eval_policy(args, env, policy, n_episodes=EPISODES, ep_len=TICKS, seed=0,
                      device="cuda")
    launches = bt.block_tridiag_solve.launches
    newton_steps = policy.newton_steps - steps0
    res.update(launches=launches, newton_steps=newton_steps,
               launches_per_tick=launches / TICKS)
    report["serve"] = res
    phase("serve done", **res)
    check(res["n_nan_episodes"] == 0, "non-finite states in the closed loop")
    check(np.isfinite(res["mean_reward"]), "non-finite reward")
    check(newton_steps > 0 and launches >= newton_steps,
          f"{launches} kernel launches for {newton_steps} Newton steps")

    # -- 6. result ------------------------------------------------------------
    main_t = timings[0]
    kernels = [{
        "name": "block_tridiag_solve", "route": "cuda",
        "source": "deqmpc_tpu_torch/ops/csrc/block_tridiag.cu",
        "replaces": "deqmpc_tpu/ops/pallas_tridiag.py:100",
        "launches": launches,
        "max_abs_err": worst[f"{MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}x{MAIN_SHAPE[2]}/torch.float32"],
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"], "library_ms": main_t["library_ms"],
    }]
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
