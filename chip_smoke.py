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
     (32,5,16) (serving), (128,5,16) (training, configs #4 and #5),
     (32,5,3) (serving the pendulum), (8,5,40) (n > 32), (1,5,16) and
     (256,5,16) (bench_streaming's vehicle and fleet) and (3,5,16) (a CTA
     of the warp kernel part empty), in f32 and f64, with one non-SPD
     sample per case that must come back NaN while its neighbours stay
     finite (a batch of one: checked SPD, then not SPD): the kernel the
     wrapper picks at every shape, and the block kernel by name at the
     shapes the warp kernel takes; then, at the shapes of TIMED_SHAPES
     ((128,5,16) in f64 too), both kernels' call time and device time
     (torch.profiler) beside the plain version, the dense-Cholesky
     library call and the bound;
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
     ticks, no NaN, every solve through the warp kernel at n = 3;
  9. serve `checkpoints/rexquad_streaming` (config #5) warm-started: tick
     0 and 2 warm ticks of 4 start states on the card against the CPU, f32
     and f64, tick 0 within ACTION_TOL and the warm ticks within
     WARM_ACTION_TOL, beside the card's own f64 move under observations
     moved by 1e-12 and the card's f64 ticks with the plain solve in place
     of the kernel; a planted fault (the carry left unshifted) that the f64
     warm ticks must reject; then 32 episodes x 10
     ticks through `eval_policy` (tick 0 cold, the rest warm), the counts
     set to 0 just before: no NaN, every solve through the warp kernel,
     each tick's Newton steps, retries and stopped share printed;
 10. train config #5 from `checkpoints/rexquad_streaming`: the streaming
     step (a cold forward and L = 2 warm forwards on a bsz-128 batch of
     T + L = 7 expert states, the losses summed); step 0 card vs CPU (f32
     loss; f64 loss and gradient norm; the planted sign flip rejected),
     then 3 steps as for config #4, with one implicit backward per round
     of each forward (18 a step);
 11. `training/bench_streaming.py` at bsz 1 and 256, BENCH_REPS reps: its
     JSON line (cold and warm tick times, realtime margin);
 12-14. serve `checkpoints/cartpole_sac_deqmpc` (config #2, T 10, blocks
     n = 5), `checkpoints/flying_deqmpc_nn` (config #3, deq-mpc-nn, n = 18)
     and `checkpoints/flying_obstacles` (config #3b, 40 spheres, the 4
     nearest per knot as constraint rows): tick 0 of NEW_EPISODES start
     states on the card against the CPU in f32 and f64 within ACTION_TOL
     (for #3b the first OBSTACLE_STARTS states beside a sphere, so their
     rows are active, and the share of samples with an active row
     printed), a planted fault (O transposed) the f32 check must reject,
     every Newton system of the card's f32 tick 0 against the plain solve
     on the card, then NEW_EPISODES x NEW_TICKS closed-loop ticks through
     `eval_policy`, the counts set to 0 just before: no NaN, every solve
     through the warp kernel, Newton steps, retries and launches per tick;
     one more tick under torch.profiler for the device's idle share;
 15-16. train config #2 (from `cartpole_sac_deqmpc`, the SAC teacher's
     data) and config #3 (from `flying_deqmpc_nn`) as config #4: step 0
     card vs CPU (f32 loss; f64 loss and gradient norm; the planted sign
     flip rejected), 3 steps at bsz 128 on one seeded batch, all warp, one
     implicit backward per round, one profiled step;
 17-18. serve the diff-mpc arms `checkpoints/pendulum_diffmpc_deq` (n = 3)
     and `checkpoints/flying_diffmpc_deq` (n = 18), as phases 12-14: one
     network call and a final AL solve of 10 iterations a tick; besides O
     transposed (f32), a planted final solve of 2 AL iterations that the
     f64 tick-0 check must reject;
 19. train the diff arm of config #3 from `flying_diffmpc_deq` as config
     #3: one implicit backward a step (the final solve's);
 20. serve `checkpoints/pendulum_deqmpc` with the interior-point solve
     (`solver_type="ip"`) as phases 12-14: no block-tridiagonal solve, the
     dense KKT solves per tick counted, the tick-0 check on the last round's
     whole plan, a planted fault (the SQP line search's step fixed at 1:
     on this path it is 0.2^9 on every sample, as in JAX) that the f64
     check must reject;
 21. train config #1 with the interior-point solve from a seeded fresh
     policy: step 0 card vs CPU in f64, 3 steps, one qp_layer backward a
     round; the path's first QP card vs CPU in f64, its solution (2
     interior-point iterations in place of 18 must fail) and its six input
     gradients (the pull-back with the sign flipped must fail).
 22. serve `checkpoints/flying_obstacles_aware_r5` (the obstacle-aware
     network on the dense field, 160 spheres of radius 0.4) as phases 12-14,
     besides O transposed (f32) a planted fault the f64 tick-0 check must
     reject: the obstacle features zeroed (the blind input, aware weights);
 23. train each policy variant (`--addmem`, `--policy_variant delta`,
     `history --H 3`, `estpred --H 3`, `feedback`, `q`, `history --H 3
     --deq_out_type 2`) on config #1 from a seeded fresh init, as config #4:
     step 0 card vs CPU (f64 loss and gradient norm within STEP0_RTOL), the
     sign flip and the variant's own planted fault rejected by the f64
     check (the delta's straight-through multiply by the product rule, the
     Q scaling without its +1, estpred's estimator with the initial-state
     row), the delta's scales after step 0 within DELTA_SCALES_TOL, 3 steps
     with their backward solves and zeroed share, all warp, one profiled
     step; for estpred also the estimator's systems (its Newton steps,
     retries, first solves' NaN share) against the plain solve;
 24. serve the variants JAX's eval serves (mem, delta, feedback, q): the
     train CLI trains each one step on the card and writes its port
     checkpoint, served as phases 12-14 for VARIANT_TICKS ticks;
 25-26. train config #4 from its checkpoint with `--grad_type implicit` (the
     true DEQ gradient) and with `--recompute_Qq` (the cost refresh) as
     config #4, with the rounds' solver stats per step: for implicit the
     sign flip and the one-step adjoint (w = g) rejected, the latter by the
     f64 gradient vector (VECTOR_FAULTS); for the refresh, which leaves no
     implicit backward to run, the refresh dropped rejected;
 27-28. serve `rexquad_deqmpc` with the refresh and with the bf16 trunk
     through `serve_config`'s args update, TICKS closed-loop ticks; for
     bf16 also the trunk's one application card vs CPU within
     BF16_TRUNK_TOL, which the card's f32 trunk must fail (its f64 tick 0
     printed, not held: the f64 policy's matmuls still round to bf16);
 29. train config #1 from a seeded fresh init under each of SLICE8_FLAGS
     (Broyden, Broyden implicit, multi last-step, multi BPTT, bf16,
     `--grad_coeff --val_every 1`: the step-0 ratios card vs CPU in f64 and
     the coefficients after each step);
 30. train config #3 with `Qscale` 2;
 31. train config #4 from its checkpoint with the args `--dtype double` sets
     (the solver in f64 at rho_max 1e8, the network in f32) as config #4:
     step 0 card vs CPU, the sign flip rejected, 3 steps, every solve through
     the warp kernel at (128,5,16) f64, 6 backward solves a step;
 32. the train CLI (`train.main`) on config #1 from a fresh init with
     CLI_FLAGS (`--lr_schedule cosine --data_noise_type 2 --loss_type l2
     --policy_out_type 2 --kernel_width 5 --num_trajs_frac 0.5 --start_iter 201
     --max_train_steps 205 --val_every 2 --save`), into a temporary directory:
     finite losses, metrics.jsonl with the JAX CLI's keys, each step's rate the
     schedule's at the optimizer's count, the checkpoint reloaded, all warp;
 33. `training/profile_step.py --n_rep 2` at its defaults (cartpole1link, T
     10, hdim 256, bsz 128): the four times finite, all warp at (128,10,5);
 34. `rexquad_deqmpc` through `train.main --eval --eval_x_window` (32 x 10
     ticks, the start states inside the window, all warp), then
     `check_param_sensitivity` on a bsz-32 batch: finite losses, the base
     loss card vs CPU within STEP0_RTOL;
 35. `expert_mpc_rexquad`: `generate_mpc_expert` on RexQuadrotor at DAgger's
     settings (horizon 30, 8 AL iterations, noise 0.1), 64 x 10, f32: tick 0
     of 8 starts card vs CPU in f64 within ACTION_TOL, every solve through the
     warp kernel at (64,30,16), its first Newton systems against the plain
     solve, finite episodes with actions inside the box, the first solve's
     dynamics residual; then the 1-link cartpole's teacher, 64 x 3 at (64,30,5);
 36. `expert_capture_cartpole2l`: the 2-link capture teacher at its defaults
     (horizon 60, 10 AL iterations, noise 0.3), 64 x 5 at (64,60,7), as 35;
 37. `expert_analytic`: the pendulum's energy teacher (256 x 200: JAX's gate,
     70% within 0.3 of upright) and the flying cascade (256 x 240: every kept
     episode within 0.25), each card vs CPU over 40 ticks; no solve;
 38. `golden_traj`: `solve_al` in f64 at (1,60,7) against the committed golden
     within JAX's test's limits, all warp; `solve_ip` at 2 SQP iterations card
     vs CPU, at 12 its distance from the golden as JAX's own;
 39. `dagger_rexquad`: one DAgger round of config #4 (`collect_policy_states`
     64 x 8 at (64,5,16), 16 corrective episodes of 5 ticks at (16,30,16),
     appended to a temporary pickle that starts from the committed dataset);
 40. `sac_pendulum`: `SACTrainer` at the CLI's defaults for 2,500 iterations,
     `generate_expert` 64 x 200, one update card vs CPU (f32); no solve;
 41. `obstacles_protocol`: `eval_obstacles.main`, the constrained arm of
     `flying_obstacles_aware_r5` on the dense field (32 x 8 at (32,5,18) with
     obstacle rows) and the filter arm of `flying_deqmpc_nn` at T_f 10 (32 x 5
     at (32,5,18) and (32,10,18));
 42. `train_rexquad_two_ranks`: `multihost_worker`'s pendulum step over two
     processes sharing the card over gloo against one process over nccl, within
     JAX_SHARD_TOL; config #4's step under `--dtype double` (the network in f64
     too) from its checkpoint over two gloo processes, 64 samples each of one
     seeded batch of 128, against the one-process step on all 128: the ranks'
     new parameters equal bit for bit, the loss, gradient norm and every
     gradient within the larger of JAX_SHARD_TOL and three times the
     one-process step's own move under 1e-14 moves (it turns on rounding); the step with
     the gradient all-reduce skipped must fail that check; one step of one
     process over nccl within JAX_SHARD_TOL; every step all warp;
 43. `native_oracle`: the card's f64 dynamics and Jacobians of the pendulum and
     the 1- and 2-link cartpoles at 1,024 states against the native C++ oracle
     (`envs/native_bridge.py`, compiled from `native/src/dynamics.cpp`) within
     `tests/test_native.py`'s tolerances;
 44. `train_flying_obstacles`: config #3b trained from
     `checkpoints/flying_obstacles` as config #3 (step 0 card vs CPU, the sign
     flip rejected, 3 steps, all warp, one profiled step), the obstacle rows in
     the forward and the implicit backward, on 64 x 240 ticks of the port's
     obstacle-filtered cascade teacher generated on the card (collision-free,
     through a temporary pickle and the data pipeline); the share of samples
     with an active obstacle row and the backward's zeroed share printed; its
     f64 step 0 (which moves by about 1% under 1e-14 moves) held within the
     larger of STEP0_RTOL and three times the card's own move.
The feedback variant's phase (23) also takes its f64 step 0 on observations
moved by 1e-14 for C5_MOVES seeds: the card's own spread beside its gap to
the CPU (ROADMAP C5).
Phase 3 also holds the kernels at the estimator's shape (128,3,3), at
T = 1, (128,1,3) and (32,1,16), at slice 10's shapes (SLICE10_SHAPES) and at
slice 11's (SLICE11_SHAPES: (8,4,3); a rank's (64,5,16) is timed in f64 too),
and each timing row gives the warp kernel's plan (warps per CTA, shared
memory or device scratch).
Phases 1-3 run first, alone. Phases 4-10 and 12-44 then run in the
worker processes of LANES, six at once, each lane's phases in turn
(each keeps the card idle over 95% of its time, so they share it);
their times are taken under that sharing. Phase 11 runs last, alone.
Before the end, one `[chip_smoke] report {...}` line holds every number
measured. The last three lines are the nvidia-smi line, the kernels JSON
and {"ok": true, "device": {...}}. Any failure raises and exits non-zero.

  python3 chip_smoke.py --phases serve_cartpole,train_flying

runs the build, the kernel checks and the named phases only (for
debugging; it prints neither the kernels line nor the ok line). Phase
names: serve_rexquad, train_rexquad, train_pendulum, serve_pendulum,
serve_streaming, train_streaming, bench_streaming, serve_cartpole,
serve_flying, serve_flying_obstacles, train_cartpole, train_flying,
serve_pendulum_diffmpc, serve_flying_diffmpc, train_diffmpc, serve_ip,
train_ip, serve_flying_aware, train_variants_{mem, delta, history,
estpred, feedback, q, history_joint}, serve_variants_{mem, delta,
feedback, q}, train_rexquad_implicit, train_rexquad_recompute,
serve_rexquad_recompute, serve_rexquad_bf16, train_slice8_{broyden,
broyden_implicit, multi_last_step, multi_bptt, bf16, grad_coeff},
train_flying_qscale, train_rexquad_double, train_pendulum_cli, profile_step,
eval_x_window, expert_mpc_rexquad, expert_capture_cartpole2l, expert_analytic,
golden_traj, dagger_rexquad, sac_pendulum, obstacles_protocol,
train_rexquad_two_ranks, native_oracle, train_flying_obstacles.
"""
import argparse
import concurrent.futures
import contextlib
import dataclasses
import fcntl
import functools
import multiprocessing
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

T0 = time.perf_counter()
CKPT = "checkpoints/rexquad_deqmpc"
PENDULUM_CKPT = "checkpoints/pendulum_deqmpc"
STREAMING_CKPT = "checkpoints/rexquad_streaming"
CARTPOLE_CKPT = "checkpoints/cartpole_sac_deqmpc"  # config #2
FLYING_CKPT = "checkpoints/flying_deqmpc_nn"  # config #3
FLYING_OBS_CKPT = "checkpoints/flying_obstacles"  # config #3b
# the diff-mpc arms: one network call, then a final AL solve of 10 iterations
PENDULUM_DIFF_CKPT = "checkpoints/pendulum_diffmpc_deq"
FLYING_DIFF_CKPT = "checkpoints/flying_diffmpc_deq"  # config #3's diff arm
# the obstacle-aware network on the dense field (160 spheres, r 0.4)
AWARE_CKPT = "checkpoints/flying_obstacles_aware_r5"
# the policy variants, trained on config #1 from a seeded fresh init: the
# train CLI's flags of each, and the history window
VARIANT_H = 3
VARIANT_FLAGS = {"mem": ["--addmem"], "delta": ["--policy_variant", "delta"],
                 "history": ["--policy_variant", "history", "--H", str(VARIANT_H)],
                 "estpred": ["--policy_variant", "estpred", "--H", str(VARIANT_H)],
                 "feedback": ["--policy_variant", "feedback"], "q": ["--policy_variant", "q"],
                 "history_joint": ["--policy_variant", "history", "--H", str(VARIANT_H),
                                   "--deq_out_type", "2"]}
# the variants JAX's eval serves (one state in): trained for one step by the
# train CLI, which writes the port checkpoint they are served from
SERVED_VARIANTS = ("mem", "delta", "feedback", "q")
VARIANT_TICKS = 10
EPISODES, TICKS = 32, 10
PENDULUM_EPISODES, PENDULUM_TICKS = 32, 20
TRAIN_BSZ, TRAIN_STEPS, PENDULUM_TRAIN_STEPS = 128, 3, 5
# config #5: start states of the card-vs-CPU ticks, warm ticks after tick 0,
# the closed loop, and the bench's reps
STREAM_STATES, STREAM_WARM_TICKS = 4, 2
STREAM_EPISODES, STREAM_TICKS = 32, 10
BENCH_FLEET, BENCH_REPS = 256, 3
# configs #2, #3 and #3b: the tick-0 states and the closed loop (10 ticks, 20
# before slice 8's phases joined the lanes, to keep the smoke's time); in
# #3b's tick-0 check the first OBSTACLE_STARTS states start beside a sphere
NEW_EPISODES, NEW_TICKS, OBSTACLE_STARTS = 32, 10, 8
SERVE_SHAPE = (EPISODES, 5, 16)  # the solve's shape on the served path
TRACE_WAIT_S = 0.05  # the profiler's wait before a traced call and after its sync
TRACE_LOCK = None  # in a lane: the file whose lock the lanes take in turn to trace
# the solve's shape in the config-#4 and config-#5 training steps, forward
# and backward, whose numbers the kernels line reports
MAIN_SHAPE = (TRAIN_BSZ, 5, 16)
PENDULUM_SERVE_SHAPE = (PENDULUM_EPISODES, 5, 3)  # the served pendulum's solve
# bench_streaming's single vehicle and fleet, and a batch that leaves the
# warp kernel's last CTA part empty
STREAM_SHAPES = [(1, 5, 16), (3, 5, 16), (BENCH_FLEET, 5, 16)]
# the cartpole's blocks (T 10, n 5) and the flying cartpole's (T 5, n 18),
# served and trained
NEW_SHAPES = [(NEW_EPISODES, 10, 5), (TRAIN_BSZ, 10, 5), (NEW_EPISODES, 5, 18),
              (TRAIN_BSZ, 5, 18)]
# the estpred estimator's systems (horizon H, the pendulum's n), and T = 1
MHE_SHAPE = (TRAIN_BSZ, VARIANT_H, 3)
T1_SHAPES = [(TRAIN_BSZ, 1, 3), (NEW_EPISODES, 1, 16)]
# slice 10: the MPC teachers at horizon 30 (rexquad, the 1-link cartpole; DAgger's
# correctives), the capture teacher at 60, the golden AL solve (f64), DAgger's policy
# rollout, the safety filter at T_f 10 and the obstacle protocol's 512 lanes
SLICE10_SHAPES = [(64, 30, 16), (64, 30, 5), (64, 60, 7), (1, 60, 7), (64, 5, 16),
                  (16, 30, 16), (32, 10, 18), (512, 5, 18), (512, 10, 18)]
# slice 11: a rank's slice of the multi-host worker's pendulum step (T 4,
# f64); a rank's half of config #4's batch is DAgger's (64,5,16), timed here
# in f64 too
RANK_SHAPE = (TRAIN_BSZ // 2, 5, 16)
SLICE11_SHAPES = [(8, 4, 3)]
KERNEL_SHAPES = [(1024, 5, 16), (128, 5, 3), (64, 20, 18), (4, 200, 18), SERVE_SHAPE,
                 MAIN_SHAPE, PENDULUM_SERVE_SHAPE, (8, 5, 40), *STREAM_SHAPES, *NEW_SHAPES,
                 MHE_SHAPE, *T1_SHAPES, *SLICE10_SHAPES, *SLICE11_SHAPES]
TIMED_SHAPES = [(MAIN_SHAPE, torch.float32), (SERVE_SHAPE, torch.float32),
                (MAIN_SHAPE, torch.float64),  # config #4's step under --dtype double
                ((1024, 5, 16), torch.float32), ((128, 5, 3), torch.float32),
                ((64, 20, 18), torch.float64), ((1, 5, 16), torch.float32),
                ((BENCH_FLEET, 5, 16), torch.float32),
                (PENDULUM_SERVE_SHAPE, torch.float32),
                *[(shape, torch.float32) for shape in NEW_SHAPES],
                (MHE_SHAPE, torch.float32), (T1_SHAPES[0], torch.float32),
                *[(shape, torch.float64 if shape == (1, 60, 7) else torch.float32)
                  for shape in SLICE10_SHAPES], (RANK_SHAPE, torch.float64)]
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
# rexquad_streaming's warm ticks, card vs CPU. In f64 one of the 4 states
# jumps at each warm tick: it moved by 2.2e-2 (tick 1) and 0.10 (tick 2)
# card vs CPU, as far as the planted unshifted carry moves it, while the
# median stayed at 2.3e-6 and 8.5e-5 (PERF.md, PR 7). On the CPU, JAX's own
# warm-tick action for such a state moves by 5.2e-4 under a 1e-14 move of
# the observations. So the f64 warm ticks are held by the median, which the
# planted fault moves to 1.8e-3 and 6.8e-3
WARM_ACTION_TOL = {torch.float32: ACTION_TOL[torch.float32],
                   torch.float64: {"median": ACTION_TOL[torch.float64]["median"]}}
# the delta variant's scales after the f64 step 0 (Adam, then the EMA of the
# rounds' median errors), card vs CPU, largest absolute gap: Adam's first
# step moves each scale by about lr = 1e-3 whatever its gradient's size, so
# a gradient sign that rounding flipped would show as 2e-3; the EMA adds 0.02
# of medians of trajectories whose f64 card-vs-CPU gaps reach 1e-5 relative
# (the variants' f64 step-0 losses: 6.1e-6 and 2.0e-5, PERF.md)
DELTA_SCALES_TOL = 1e-4


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


def trace(fn, what):
    """One call of `fn` under torch.profiler (device activity only), synced:
    (the profile, its wall seconds). `fn` runs once before it, untraced, in
    the profiler's warm-up step: CUDA's tracer, started cold, loses the
    records of the first kernels it sees now and then (on an H100 with six
    processes tracing at once, 69 of 72 traces of a 30,002-kernel call lost
    1-8 kernels at their head, and none of 72 after a warm-up call:
    `deqmpc_tpu_torch/training/trace_tail.py`, ways `wait_before_and_after`
    and `warmup_call`). The profiler runs TRACE_WAIT_S before the traced
    call and after its sync: stopped at once, it now and then drops the
    records of a call's last kernels. The lanes trace one at a time
    (TRACE_LOCK): with six processes tracing at once, now and then one
    trace in a whole smoke showed 32-39 of the 38-43 launches its served
    tick or training step made, warm-up call or not (on an H100). A trace
    that holds no device event at all is a tracing failure, not the
    program's (on an H100, CUPTI recorded nothing for one profile of two
    runs, the next ones in the same process everything): it is said and
    `fn` traced once more."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in (1, 2):
        torch.cuda.synchronize()
        with trace_turn(), profile(activities=[ProfilerActivity.CUDA],
                                   schedule=schedule(wait=0, warmup=1, active=1,
                                                     repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(TRACE_WAIT_S)
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            time.sleep(TRACE_WAIT_S)
            prof.step()
        if device_events(prof):
            return prof, wall
        print(f"[chip_smoke]   the profiler recorded no device event in {what} "
              f"(attempt {attempt})", flush=True)
    return prof, wall


@contextlib.contextmanager
def trace_turn():
    """Hold TRACE_LOCK, where there is one, across the block."""
    if TRACE_LOCK is None:
        yield
        return
    with open(TRACE_LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def device_events(prof):
    """The profile's device events: the kernels, memcpys and memsets (the
    profiler's step annotation, which spans the step, left out)."""
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


def device_ms(fn, key, iters=50):
    """The kernel's own device time per launch: torch.profiler's device
    time of the kernels whose name holds `key`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    prof, _ = trace(calls, f"{iters} calls of {key}")
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
    lib = bt._load_library()
    warps, smem = bt._plan(lib, "warp", T, n, D.element_size(), bt._smem_optin(lib, 0))
    row = {"shape": [bsz, T, n], "dtype": str(dtype).replace("torch.", ""),
           "warp_plan": {"warps_per_cta": warps, "shared_memory": smem},
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
    `before` (a dict of the policy's counts taken at the start), and the
    interior-point path's dense KKT solves (forward and backward)."""
    now = policy_counts(policy)
    return {**launch_counts(bt), **{k: now[k] - before[k] for k in now}}


def launch_counts(bt):
    """Launches since `reset_counts`, in all and by kernel."""
    return {"launches": bt.block_tridiag_solve.launches,
            "launches_by_kernel": dict(bt.block_tridiag_solve.launches_by_kernel)}


def policy_counts(policy):
    from deqmpc_tpu_torch.solvers import pdipm

    return {"newton_steps": policy.newton_steps, "retries": policy.newton_retries,
            "backward_solves": policy.backward_solves,
            "ip_kkt_solves": pdipm.counts["kkt"], "ip_backward_solves": pdipm.counts["backward"]}


def check_all_warp(counts, what):
    by = counts["launches_by_kernel"]
    check(counts["launches"] > 0 and by["warp"] == counts["launches"] and by["block"] == 0,
          f"{what}: not every solve went through the warp kernel: {by}")
    solves = counts["newton_steps"] + counts["retries"] + counts["backward_solves"]
    check(counts["launches"] == solves,
          f"{what}: {counts['launches']} launches for {solves} solves ({counts})")


def rel_gap(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def profiled(bt, fn, what):
    """One call of `fn` under torch.profiler after a warm-up call (`trace`;
    device activity only: host events of ~100k ops take minutes to sum):
    its wall time, the device's
    busy time and idle share, and the warp kernel's launches and time.
    Fails unless the profiler recorded device time and every launch of the
    warp kernel that its wrapper counted in the call, and no more."""
    before = []

    def call():  # the counts at the start of the traced call
        before[:] = [bt.block_tridiag_solve.launches_by_kernel["warp"]]
        fn()

    prof, wall = trace(call, what)
    kernels = device_events(prof)
    solve = [e for e in kernels if bt.KERNEL_FUNCTIONS["warp"] in e.key]
    counted = bt.block_tridiag_solve.launches_by_kernel["warp"] - before[0]
    seen = sum(e.count for e in solve)
    if seen != counted:  # where in the call the trace lost or gained launches
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
        starts = sorted(e.time_range.start / 1e3 for e in events
                        if bt.KERNEL_FUNCTIONS["warp"] in e.name)
        print(f"[chip_smoke]   {what}: the warp kernel's starts {[round(t, 2) for t in starts]} "
              f"ms into the trace, its device events from "
              f"{min(e.time_range.start for e in events) / 1e3:.2f} to "
              f"{max(e.time_range.end for e in events) / 1e3:.2f} ms, the call {wall * 1e3:.1f} "
              f"ms", flush=True)
    busy_us = sum(dev_us(e) for e in kernels)
    check(kernels and busy_us > 0, f"{what}: the profiler recorded no device time")
    check(seen == counted, f"{what}: the profiler shows {seen} launches of the warp kernel, "
                           f"its wrapper counted {counted}")
    # the dense factorizations and solves of torch.linalg (the interior-point
    # path's KKT systems): cuSOLVER/cuBLAS/MAGMA kernels by name
    dense = [e for e in kernels if re.search(r"getrf|getf2|getrs|laswp|pivinfo|displace_pointers|"
                                             r"potrf|potrs|trsm|trsv|magma|cusolver|solve",
                                             e.key, re.I)
             and not any(k in e.key for k in bt.KERNEL_FUNCTIONS.values())]
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    return {"wall_s": wall, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "warp_kernel_launches": seen,
            "warp_kernel_device_ms": sum(dev_us(e) for e in solve) / 1e3,
            "dense_linalg_launches": sum(e.count for e in dense),
            "dense_linalg_device_ms": sum(dev_us(e) for e in dense) / 1e3,
            "top_kernels": [[e.key[:70], e.count, dev_us(e) / 1e3] for e in top]}


def flip_newton_backward(newton_al):
    """The planted fault of a training step: the implicit backward's
    gradients into Q and q with their signs flipped. Returns the undo."""
    good = newton_al.implicit_grads
    newton_al.implicit_grads = lambda *a: (lambda dQ, dq, z: (-dQ, -dq, z))(*good(*a))
    return lambda: setattr(newton_al, "implicit_grads", good)


def flip_qp_layer_backward(pdipm):
    """The interior-point path's planted fault: the qp_layer backward pulls
    back w in place of -w. Returns the undo."""
    good = pdipm._pull_back
    pdipm._pull_back = lambda v, sol: good(-v, sol)
    return lambda: setattr(pdipm, "_pull_back", good)


def policy_in(build_policy, args, env, dev, dtype, obstacles=None):
    """The policy `args` describe, with its solver (and, for f64, its
    network) in `dtype` and the args' rho_max (1e5 unless they say). Args
    with `dtype` double (`--dtype double`) keep the solver in f64 and
    rho_max 1e8 unless they say, whatever the network's dtype."""
    double = args.get("dtype") == "double"
    rho_max = args.get("rho_max") or (1e8 if double else 1e5)
    p = build_policy({**args, "dtype": "double" if double or dtype == torch.float64
                      else "float32", "rho_max": rho_max}, env, dev, obstacles=obstacles)
    p.model.to(dtype)
    return p


def train_config(bt, train, build_policy, newton_al, state, args, env, batch_np, loss=None,
                 sensitivity=True, planted=True, faults=(), grad_coeff=False, obstacles=None,
                 moves=0):
    """A training step of a checkpoint's configuration (#4, #2 or #3; #5
    with the streaming `loss`; the diff-mpc arm; #1 with the interior-point
    solve, or a policy variant, from a fresh `state`): step 0 on the card
    against the CPU, in f32 (the trained configuration) and f64 (tight),
    with `sensitivity` each beside the card's own move under a perturbation
    of the start states; with `planted`, the f64 step 0 with the implicit
    NewtonAL backward's signs flipped, and so for each of `faults`, (name,
    plant(policy) -> undo); then TRAIN_STEPS steps on the card (the main
    path) and one profiled step. For the delta variant, the scales after
    the f64 step 0 (Adam, then their EMA), card vs CPU. Each step records
    the rounds' solver stats (`deq_stats`) where the network runs a solver.
    With `grad_coeff` (`--grad_coeff --val_every 1`), the ratios at the
    starting weights card vs CPU in f64 and, after each of the TRAIN_STEPS
    steps, the ratios on the same batch and the coefficients' EMA, which the
    next step takes (their solves counted with the step's). `obstacles`: the
    env's field, for a policy with obstacle rows. With `moves`, the card's
    own spread (`own_spread_f64`): its f64 step 0 once more on observations
    moved by 1e-14 relative, for each of `moves` seeds (the moves of
    `tests/test_torch_variants_c5.py`), beside its gap to the CPU."""
    from deqmpc_tpu_torch.training.grad_coeffs import (compute_grad_ratio_coeffs,
                                                       update_coeffs_ema)

    loss = loss or train.loss_fn

    def fresh(dev, dtype=torch.float32):
        p = policy_in(build_policy, args, env, dev, dtype, obstacles=obstacles)
        p.model.load_state_dict({k: v.to(dev) for k, v in state.items()})
        return p, train.make_optimizer(p)

    def step0(dev, dtype, rel_noise=0.0, plant=None, scales=False, noise_seed=1):
        b = dict(batch_np)
        noise = np.random.default_rng(noise_seed).normal(size=b["obs"].shape)
        b["obs"] = b["obs"].astype(np.float64) * (1 + rel_noise * noise)
        p, o = fresh(dev, dtype)
        undo = plant(p) if plant is not None else None
        try:
            t = time.perf_counter()
            res = train.train_step(p, o, train.to_device(b, dev, dtype), loss=loss)
        finally:
            if undo is not None:
                undo()
        out = {"loss": float(res["loss"]), "grad_norm": float(res["grad_norm"]),
               "s": time.perf_counter() - t, **stats_of(res)}
        if dtype == torch.float64:  # the clipped gradient, for vector gaps
            out["grad_vec"] = torch.cat([q.grad.detach().double().cpu().flatten()
                                         for q in p.model.parameters() if q.grad is not None])
        if grad_coeff and plant is None and dtype == torch.float64:
            # the ratios at the starting weights: after Adam's first step,
            # about lr * sign(g) on every weight, a gradient entry's sign that
            # rounding flips would move the weights by 2 lr
            p0, _ = fresh(dev, dtype)
            out["ratios"] = compute_grad_ratio_coeffs(
                p0, train.to_device(b, dev, dtype), qp_solve=p0.cfg.qp_solve)[0].cpu().tolist()
        if scales and p.is_delta:  # after Adam and the EMA
            out["scales"] = p.model.scales.detach().cpu().double()
        return out

    def gaps(a, b):
        return {k: rel_gap(a[k], b[k]) for k in ("loss", "grad_norm")}

    out = {"cpu_step0": step0("cpu", torch.float32),
           "cpu_step0_f64": step0("cpu", torch.float64, scales=True),
           "card_step0_f64": step0("cuda", torch.float64, scales=True)}
    out["step0_gap_card_vs_cpu_f64"] = gaps(out["card_step0_f64"], out["cpu_step0_f64"])
    if sensitivity:
        out["card_step0_moved_1e-6"] = step0("cuda", torch.float32, 1e-6)
        out["card_step0_f64_moved_1e-12"] = step0("cuda", torch.float64, 1e-12)
        out["step0_gap_sensitivity_f64_1e-12"] = gaps(out["card_step0_f64_moved_1e-12"],
                                                      out["card_step0_f64"])
    if moves:  # the card's own spread under 1e-14 moves, beside its gap to the CPU
        moved = [gaps(step0("cuda", torch.float64, 1e-14, noise_seed=s), out["card_step0_f64"])
                 for s in range(moves)]
        spread = {k: max(m[k] for m in moved) for k in ("loss", "grad_norm")}
        gap = out["step0_gap_card_vs_cpu_f64"]
        out["own_spread_f64"] = {"moves_1e-14": moved, "spread": spread, "card_vs_cpu": gap,
                                 "within": {k: gap[k] <= spread[k] for k in spread}}
        print(f"[chip_smoke]   the card's own f64 spread: {json.dumps(out['own_spread_f64'])}",
              flush=True)
    if planted:  # a planted fault the f64 check should see
        undo = flip_newton_backward(newton_al)
        try:
            out["card_step0_f64_planted_sign_flip"] = step0("cuda", torch.float64)
        finally:
            undo()
        out["step0_gap_planted_sign_flip_f64"] = gaps(out["card_step0_f64_planted_sign_flip"],
                                                      out["cpu_step0_f64"])
    def vector_gap(a):
        ref = out["cpu_step0_f64"]["grad_vec"]
        return float(torch.linalg.vector_norm(a["grad_vec"] - ref) / torch.linalg.vector_norm(ref))

    out["step0_grad_vector_gap_card_vs_cpu_f64"] = vector_gap(out["card_step0_f64"])
    for name, plant in faults:
        bad = step0("cuda", torch.float64, plant=plant)
        out.setdefault("planted_f64", {})[name] = {**gaps(bad, out["cpu_step0_f64"]),
                                                   "grad_vector": vector_gap(bad)}
    if grad_coeff:
        r_card, r_cpu = (np.asarray(out[k]["ratios"]) for k in ("card_step0_f64",
                                                                "cpu_step0_f64"))
        out["step0_ratios_gap_card_vs_cpu_f64"] = float(np.max(np.abs(r_card - r_cpu)
                                                               / np.abs(r_cpu)))
    for key in [k for k in out if isinstance(out[k], dict) and "grad_vec" in out[k]]:
        del out[key]["grad_vec"]
    if "scales" in out["cpu_step0_f64"]:
        out["delta_scales_after_step0_f64_max_abs_gap"] = float(
            (out["card_step0_f64"].pop("scales") - out["cpu_step0_f64"].pop("scales")).abs().max())

    policy, opt = fresh("cuda")
    batch = train.to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    before = policy_counts(policy)
    reset_counts(bt)
    steps = []
    newton = policy.newton_solver
    coeffs = torch.ones((policy.cfg.deq_iter, 3), device="cuda") if grad_coeff else None
    for _ in range(TRAIN_STEPS):
        c0, by0 = policy_counts(policy), dict(bt.block_tridiag_solve.launches_by_kernel)
        z0, n0 = float(newton.backward_zeroed), newton.backward_samples
        timings = {}
        t = time.perf_counter()
        res = train.train_step(policy, opt, batch, timings=timings, loss=loss, coeffs=coeffs)
        step_s = time.perf_counter() - t  # train_step synchronised the card
        extra = {}
        if grad_coeff:
            ratios = compute_grad_ratio_coeffs(policy, batch, qp_solve=policy.cfg.qp_solve)[0]
            coeffs = update_coeffs_ema(coeffs, ratios)
            extra = {"ratios": ratios.cpu().tolist(), "coeffs": coeffs[:, 0].cpu().tolist()}
        c1 = policy_counts(policy)
        steps.append({"loss": float(res["loss"]), "grad_norm": float(res["grad_norm"]),
                      "step_s": step_s, **timings, **stats_of(res), **extra,
                      "zeroed_share": (float(newton.backward_zeroed) - z0)
                      / max(newton.backward_samples - n0, 1),
                      **{k: c1[k] - c0[k] for k in c1},
                      "launches_by_kernel": {k: bt.block_tridiag_solve.launches_by_kernel[k] - by0[k]
                                             for k in bt.KERNELS}})
    out["counts"] = path_counts(bt, policy, before)
    out["deq_iter"] = policy.cfg.deq_iter
    out["mode"] = {k: getattr(policy.cfg, k) for k in ("qp_solve", "lastqp_solve", "solver_type")}
    out["backward_zeroed_share"] = policy.backward_zeroed_share()
    out["steps"] = steps
    out["card_step0"] = {k: steps[0][k] for k in ("loss", "grad_norm")}
    out["step0_gap_card_vs_cpu"] = gaps(out["card_step0"], out["cpu_step0"])
    if sensitivity:
        out["step0_gap_sensitivity_1e-6"] = gaps(out["card_step0_moved_1e-6"], out["card_step0"])
    step_s = float(np.median([s["step_s"] for s in steps]))
    out["step_s_median"] = step_s
    for part in ("forward_s", "backward_s", "optimizer_s"):
        out[f"{part}_median"] = float(np.median([s[part] for s in steps]))
    out["backward_share"] = out["backward_s_median"] / step_s

    # one more step under the profiler: the kernel's device time per step
    out["profiled_step"] = profiled(bt, lambda: train.train_step(policy, opt, batch, loss=loss),
                                    f"a profiled {args['env']} training step")
    return out


# planted faults that move the gradient's direction more than its norm: the
# one-step adjoint (w = g) of config #4's implicit step moved the f64 gradient
# norm by 1.4% on an H100 (the cell contracts fast), under STEP0_RTOL's 5e-2,
# and the whole f64 gradient vector by 27.6%, where the card moved it from
# the CPU by 3.6% (relative norm of the difference; half the backward's
# samples are zeroed, and which half turns on rounding). Such a phase holds
# the f64 gradient vector, card vs CPU, within VECTOR_GAP_TOL, and the fault
# must move it beyond
VECTOR_FAULTS = ("implicit_one_step_adjoint",)
VECTOR_GAP_TOL = 0.1


def stats_of(res):
    """A step's rounds' solver stats, as lists, where it has them."""
    return {f"deq_{k}": v.cpu().tolist() for k, v in res.get("deq_stats", {}).items()}


def check_train(tr, what, forwards=1, dtypes=(torch.float32, torch.float64), backward=None,
                spread_factor=None):
    """The checks of a training phase: finite steps, one implicit backward
    per round of each forward (for a diff-mpc step, the final solve's one;
    for the interior-point path, one qp_layer backward a round and no
    block-tridiagonal solve; `backward` a step where the phase says),
    every solve through the warp kernel, step 0 card vs CPU within
    STEP0_RTOL in `dtypes`, the planted faults (where the phase planted
    them) rejected, and the profiled step's launches. With `spread_factor`
    (a step that turns on rounding, its `own_spread_f64` measured), the f64
    step 0 within the larger of STEP0_RTOL and `spread_factor` times the
    card's own move under 1e-14 moves."""
    mode = tr["mode"]
    ip = mode["solver_type"] == "ip"
    # backward solves a step: one a round with a solve in every round, one
    # for a final solve
    if backward is None:
        backward = 0 if ip else (tr["deq_iter"] * forwards if mode["qp_solve"] else
                                 int(mode["lastqp_solve"]))
    for i, s_ in enumerate(tr["steps"]):
        check(np.isfinite(s_["loss"]) and np.isfinite(s_["grad_norm"]),
              f"{what} step {i}: loss {s_['loss']}, grad norm {s_['grad_norm']}")
        check(s_["backward_solves"] == backward
              and s_["launches_by_kernel"]["warp"] == s_["newton_steps"] + s_["retries"]
              + s_["backward_solves"] and s_["launches_by_kernel"]["block"] == 0,
              f"{what} step {i}: solves and launches disagree: {s_}")
        if ip:
            check(s_["ip_backward_solves"] == tr["deq_iter"] and s_["ip_kkt_solves"] > 0,
                  f"{what} step {i}: interior-point solves {s_}")
    if ip:
        check(tr["counts"]["launches"] == 0, f"{what}: block-tridiagonal launches on the IP path")
        check(tr["profiled_step"]["dense_linalg_launches"] > 0,
              f"{what}: no dense solve in the profiled step: {tr['profiled_step']}")
    else:
        check_all_warp(tr["counts"], what)
    check(tr["counts"]["backward_solves"] == TRAIN_STEPS * backward,
          f"{what}: {tr['counts']['backward_solves']} backward solves in {TRAIN_STEPS} steps")
    for dtype, key in ((torch.float32, "step0_gap_card_vs_cpu"),
                       (torch.float64, "step0_gap_card_vs_cpu_f64")):
        if dtype not in dtypes:
            continue
        for k, lim in STEP0_RTOL[dtype].items():
            if spread_factor is not None and dtype == torch.float64:
                lim = max(lim, spread_factor * tr["own_spread_f64"]["spread"][k])
            check(tr[key][k] <= lim,
                  f"{what} step 0 {k} ({dtype}), card vs CPU: relative gap {tr[key][k]} > {lim}")
    planted = tr.get("step0_gap_planted_sign_flip_f64")
    check(planted is None or planted["grad_norm"] > STEP0_RTOL[torch.float64]["grad_norm"],
          f"{what}: the f64 step-0 check passed a planted fault: {planted}")
    for name, gap in tr.get("planted_f64", {}).items():
        if name in VECTOR_FAULTS:  # held by the f64 gradient vector
            vec = tr["step0_grad_vector_gap_card_vs_cpu_f64"]
            check(vec <= VECTOR_GAP_TOL < gap["grad_vector"],
                  f"{what}: the f64 gradient vector, card vs CPU {vec}, beyond "
                  f"{VECTOR_GAP_TOL}, or the planted fault ({name}) within it: {gap}")
            continue
        check(any(gap[k] > lim for k, lim in STEP0_RTOL[torch.float64].items()),
              f"{what}: the f64 step-0 check passed a planted fault ({name}): {gap}")


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


def serve_streaming(bt, tridiag, newton_al, DEQMPCPolicy, PolicyCarry, build_policy,
                    load_checkpoint, make_env, eval_policy):
    """`rexquad_streaming` (config #5), warm-started: tick 0 and
    STREAM_WARM_TICKS warm ticks of STREAM_STATES start states on the card
    and on the CPU, in f32 and f64, the observations driven by the CPU's
    actions; in f64 also the card's ticks under observations moved by 1e-12
    and with the plain solve in place of the kernel, each against the
    card's or the CPU's; a planted fault (the carry left unshifted) that
    the f64 warm ticks must reject; then STREAM_EPISODES x STREAM_TICKS closed-loop
    ticks through `eval_policy` with the counts set to 0 just before, and
    per tick its Newton steps, retries and stopped share."""
    state, args = load_checkpoint(STREAMING_CKPT, "cuda")
    env = make_env(args["env"])
    policy = build_policy(args, env, "cuda")
    policy.model.load_state_dict(state)
    check(args["streaming"] and policy.rho_warm_max == 10.0,
          f"{STREAMING_CKPT}: streaming {args.get('streaming')}, rho_warm_max {policy.rho_warm_max}")
    x0 = env.reset(torch.Generator().manual_seed(0), STREAM_STATES, device="cpu",
                   dtype=torch.float64)
    out = {"gaps": {}, "status": {}}

    def ticks(p, dev, dtype, obs_seq):
        """First actions and status of tick 0 and the warm ticks, each
        tick's observation from `obs_seq` (None: step the env with this
        policy's own actions)."""
        us, status, carry, obs = [], [], None, x0
        for t in range(1 + STREAM_WARM_TICKS):
            if obs_seq is not None:
                obs = obs_seq[t]
            o = obs.to(dev, dtype)
            res = p.forward(o) if t == 0 else p.forward_warm_start(o, carry)
            carry = res["carry"]
            us.append(res["trajs"][-1][2][:, 0])
            status.append(float(res["status"].float().mean()))
            if obs_seq is None:
                obs, _ = env.step(obs, us[-1].to("cpu", torch.float64))
        return us, status

    def unshifted(aux, sol_state):  # the planted fault
        return PolicyCarry(z=aux["z"].detach(), x=aux["x"].detach(), u=aux["u"].detach(),
                           solver=sol_state)

    with torch.inference_mode():
        for dtype in (torch.float32, torch.float64):
            pols = {}
            for dev in ("cpu", "cuda"):
                pols[dev] = DEQMPCPolicy(dataclasses.replace(policy.cfg, solver_dtype=dtype),
                                         env, dev)
                pols[dev].model.load_state_dict(state)
                pols[dev].model.to(dtype)
            # the CPU's run sets the observations both devices see
            obs_seq = [x0]
            u_cpu, st_cpu = ticks(pols["cpu"], "cpu", dtype, None)
            for u in u_cpu[:-1]:
                obs_seq.append(env.step(obs_seq[-1], u.double())[0])
            u_card, st_card = ticks(pols["cuda"], "cuda", dtype, obs_seq)
            key = str(dtype)
            out["gaps"][key] = [action_gap(a, b) for a, b in zip(u_card, u_cpu)]
            out["status"][key] = {"card": st_card, "cpu": st_cpu}
            print(f"[chip_smoke]   {dtype}: per-tick action gap {json.dumps(out['gaps'][key])}, "
                  f"stopped share {json.dumps(out['status'][key])}", flush=True)
            if dtype == torch.float64:
                # the card's own rounding sensitivity: observations moved by 1e-12
                gen = torch.Generator().manual_seed(1)
                moved = [o * (1 + 1e-12 * torch.randn(o.shape, generator=gen, dtype=o.dtype))
                         for o in obs_seq]
                u_moved, _ = ticks(pols["cuda"], "cuda", dtype, moved)
                out["gaps"]["card_sensitivity_1e-12_f64"] = [action_gap(a, b.cpu()) for a, b
                                                             in zip(u_moved, u_card)]
                print("[chip_smoke]   card f64 sensitivity to 1e-12, per tick "
                      f"{json.dumps(out['gaps']['card_sensitivity_1e-12_f64'])}", flush=True)
                # does the card-vs-CPU gap come from the kernel?
                good_solve = newton_al.block_tridiag_solve
                newton_al.block_tridiag_solve = tridiag.block_tridiag_solve
                try:
                    u_plain, _ = ticks(pols["cuda"], "cuda", dtype, obs_seq)
                finally:
                    newton_al.block_tridiag_solve = good_solve
                out["gaps"]["plain_solve_on_card_f64"] = [action_gap(a, b)
                                                          for a, b in zip(u_plain, u_cpu)]
                print("[chip_smoke]   f64 with the plain solve on the card: per-tick gap to the "
                      f"CPU {json.dumps(out['gaps']['plain_solve_on_card_f64'])}", flush=True)
                pols["cuda"]._save_carry = unshifted
                u_bad, _ = ticks(pols["cuda"], "cuda", dtype, obs_seq)
                out["gaps"]["planted_unshifted_carry_f64"] = [action_gap(a, b)
                                                              for a, b in zip(u_bad, u_cpu)]
                print("[chip_smoke]   planted fault (carry unshifted), f64 gaps "
                      f"{json.dumps(out['gaps']['planted_unshifted_carry_f64'])}", flush=True)

    per_tick, cold, warm = [], policy.forward, policy.forward_warm_start

    def record(fn, kind):
        def wrapped(*a):
            c0 = policy_counts(policy)
            res = fn(*a)
            c1 = policy_counts(policy)
            per_tick.append({"kind": kind, "newton_steps": c1["newton_steps"] - c0["newton_steps"],
                             "retries": c1["retries"] - c0["retries"],
                             "stopped_share": float(res["status"].float().mean())})
            return res
        return wrapped

    policy.forward, policy.forward_warm_start = record(cold, "cold"), record(warm, "warm")
    torch.cuda.synchronize()
    before = policy_counts(policy)
    reset_counts(bt)
    res = eval_policy(args, env, policy, n_episodes=STREAM_EPISODES, ep_len=STREAM_TICKS, seed=0,
                      device="cuda")
    res["counts"] = path_counts(bt, policy, before)
    res["per_tick"] = per_tick
    out["closed_loop"] = res
    return out


def record_obstacle_rows(policy, obstacle_residuals):
    """Wrap the policy's AL solve so that each call with obstacles records,
    per sample, whether a row of its selected spheres is active at the
    solution. Returns the list the records go to."""
    ctrl, rows = policy.tracking_mpc.ctrl, []
    solve = ctrl.solve

    def wrapped(*a, **kw):
        res = solve(*a, **kw)
        if kw.get("obstacles") is not None:
            r, _ = obstacle_residuals(res[0], kw["obstacles"])
            rows.append((r >= 0).flatten(1).any(dim=1))
        return res

    ctrl.solve = wrapped
    return rows


def active_share(rows):
    """Of the recorded (solve, sample) pairs, and of the samples over all
    solves, the share with an active obstacle row."""
    if not rows:
        return None
    a = torch.stack(rows).float()
    return {"solves_x_samples": float(a.mean()), "samples": float(a.amax(dim=0).mean())}


def short_final_solve(tracking_mpc):
    """The planted fault of a diff-mpc forward: its final solve cut to 2 AL
    iterations (10 in the policy). Returns the undo."""
    cls = type(tracking_mpc)

    class Short(cls):
        def __call__(self, *a, al_iters=2, **kw):
            return super().__call__(*a, al_iters=min(al_iters, 2), **kw)

    tracking_mpc.__class__ = Short
    return lambda: setattr(tracking_mpc, "__class__", cls)


def ip_full_step(tracking_mpc):
    """The interior-point path's planted fault: the SQP line search always
    takes the full QP step. On this path (as in JAX) it takes the smallest
    step, 0.2^9, on every sample: the tracking cost is least at the
    reference it starts from, so no step lowers it, and a fault inside the
    QP moves the plan by 5e-7 of its size (the QP's dynamics without their
    control columns moved the f64 plan by a median of 1.2e-6). Returns the
    undo."""
    ip = tracking_mpc.ip_ctrl
    good = ip._line_search

    def full_step(xc, uc, x_new, u_new, x0, cost):
        x, u, alpha, c = good(xc, uc, x_new, u_new, x0, cost)
        return x, u, torch.ones_like(alpha), c

    ip._line_search = full_step
    return lambda: ip.__dict__.pop("_line_search", None)


def zero_obstacle_features(model):
    """The aware network's planted fault: its obstacle features zeroed, the
    blind input with the aware weights. Returns the undo."""
    from deqmpc_tpu_torch.models.deq_layer import OBSTACLE_N_SEL

    model._obstacle_feats = lambda x: torch.zeros(x.shape[:2] + (4 * OBSTACLE_N_SEL,),
                                                  dtype=x.dtype, device=x.device)
    return lambda: model.__dict__.pop("_obstacle_feats", None)


def serve_config(ckpt, bt, tridiag, newton_al, m, args_update=None, ticks=NEW_TICKS,
                 o_transposed_dtype=torch.float32):
    """A checkpoint of configs #2, #3 or #3b, of the diff-mpc arms, or
    `pendulum_deqmpc` with the interior-point solve (`args_update`), served:
    tick 0 of NEW_EPISODES start states on the card against the same
    forward on the CPU, f32 and f64, with the jittered retries of both and
    the planted faults (`o_transposed_dtype`: O transposed in the solve, with the AL solve;
    f64: the final solve cut to 2 AL iterations, with a final solve; f64:
    the SQP line search's step fixed at 1, with the interior-point solve;
    f64: the obstacle features zeroed, with the obstacle-aware network);
    every Newton
    system of the card's f32 tick 0 against the plain solve; then
    NEW_EPISODES x `ticks` closed-loop ticks through `eval_policy` with
    the counts set to 0 just before, per tick its Newton steps and retries
    (and dense interior-point solves), and one more tick under the
    profiler. With obstacles, the first OBSTACLE_STARTS tick-0 states start
    beside a sphere, and the share of samples with an active obstacle row
    is recorded at tick 0 and in the closed loop."""
    state, args = m.load_checkpoint(ckpt, "cuda")
    args = {**args, **(args_update or {})}
    env = m.make_env_of(args)
    obstacles = m.build_obstacles(env)
    policy = m.build_policy(args, env, "cuda", obstacles=obstacles)
    policy.model.load_state_dict(state)
    x0 = env.reset(torch.Generator().manual_seed(0), NEW_EPISODES, device="cpu")
    if obstacles is not None:
        x0[:OBSTACLE_STARTS, :3] = torch.as_tensor(
            env.obstacle_positions[:OBSTACLE_STARTS], dtype=x0.dtype) + 0.1
    cfg = policy.cfg
    out = {"env": args["env"], "deq_type": cfg.deq_type, "T": cfg.T, "deq_iter": cfg.deq_iter,
           "mode": {k: getattr(cfg, k) for k in ("qp_solve", "lastqp_solve", "solver_type")},
           "n": env.nx + env.nu, "ncon": policy.tracking_mpc.ctrl.ncon, "gaps": {},
           "retries": {}, "planted": {}}
    systems = []

    def first_actions(p, x):
        """The first actions; with the interior-point solve the last round's
        whole plan (states, then actions): its first actions are the QP's
        times the line search's 0.2^9, about 1e-6."""
        _, xs, us = p.forward(x)["trajs"][-1]
        if cfg.solver_type == "ip":
            return torch.cat([xs.flatten(1), us.flatten(1)], dim=1)
        return us[:, 0]

    with torch.inference_mode():
        for dtype in (torch.float32, torch.float64):
            pols = {}
            for dev in ("cuda", "cpu"):
                pols[dev] = policy_in(m.build_policy, args, env, dev, dtype, obstacles)
                pols[dev].model.load_state_dict(state)
            rows = record_obstacle_rows(pols["cuda"], m.obstacle_residuals)
            # keep every Newton system the card solves in f32
            with record_systems(newton_al, limit=None if dtype == torch.float32 else 0) as rec:
                t = time.perf_counter()
                u = {"cuda": first_actions(pols["cuda"], x0.to("cuda", dtype))}
                torch.cuda.synchronize()
                out[f"card_tick0_s_{dtype}"] = time.perf_counter() - t
            systems += rec.of_dtype(torch.float32)
            u["cpu"] = first_actions(pols["cpu"], x0.to("cpu", dtype))
            check(bool(torch.isfinite(u["cuda"]).all()), f"{ckpt}: non-finite action ({dtype})")
            out["retries"][str(dtype)] = {dev: {"newton_steps": p.newton_steps,
                                               "retries": p.newton_retries}
                                         for dev, p in pols.items()}
            out["gaps"][str(dtype)] = g = action_gap(u["cuda"], u["cpu"])
            out[f"tick0_active_obstacle_share_{dtype}"] = active_share(rows)
            print(f"[chip_smoke]   {ckpt} {dtype}: tick-0 action gap {json.dumps(g)}, retries "
                  f"{json.dumps(out['retries'][str(dtype)])}, active obstacle rows "
                  f"{json.dumps(active_share(rows))}", flush=True)
            faults = []
            if dtype == o_transposed_dtype and cfg.solver_type == "al":
                def o_transposed():
                    good_solve = newton_al.block_tridiag_solve
                    newton_al.block_tridiag_solve = lambda D, O, b: good_solve(
                        D, O.mT.contiguous(), b)
                    return lambda: setattr(newton_al, "block_tridiag_solve", good_solve)
                faults.append(("O_transposed", o_transposed))
            if dtype == torch.float64 and cfg.lastqp_solve:
                faults.append(("final_solve_2_al_iters",
                               lambda: short_final_solve(pols["cuda"].tracking_mpc)))
            if dtype == torch.float64 and cfg.solver_type == "ip":
                faults.append(("ip_line_search_full_step",
                               lambda: ip_full_step(pols["cuda"].tracking_mpc)))
            if dtype == torch.float64 and cfg.obstacle_net_input:
                faults.append(("obstacle_features_zeroed",
                               lambda: zero_obstacle_features(pols["cuda"].model)))
            for name, plant in faults:
                undo = plant()
                try:
                    u_bad = first_actions(pols["cuda"], x0.to("cuda", dtype))
                finally:
                    undo()
                out["planted"][name] = {"dtype": str(dtype), "gap": action_gap(u_bad, u["cpu"])}
                if name == "O_transposed":
                    out["gaps"]["planted_fault_O_transposed"] = out["planted"][name]["gap"]
                print(f"[chip_smoke]   planted fault {name}: tick-0 action gap "
                      f"{json.dumps(out['planted'][name]['gap'])}", flush=True)
    if cfg.compute_dtype is not None:
        out["bf16_trunk"] = bf16_trunk_gaps(policy, state, x0)
        print(f"[chip_smoke]   bf16 trunk, card vs CPU: {json.dumps(out['bf16_trunk'])}",
              flush=True)
    if cfg.solver_type == "al":  # the interior-point solve makes no block-tridiagonal solve
        check(systems, f"{ckpt}: no Newton system recorded at tick 0")
        out["served_systems"] = check_served_systems(bt, tridiag, systems, torch.float32)

    rows = record_obstacle_rows(policy, m.obstacle_residuals)
    per_tick, forward = [], policy.forward

    def record(*a):
        c0 = policy_counts(policy)
        res = forward(*a)
        c1 = policy_counts(policy)
        per_tick.append({k: c1[k] - c0[k] for k in ("newton_steps", "retries", "ip_kkt_solves")})
        return res

    policy.forward = record
    torch.cuda.synchronize()
    before = policy_counts(policy)
    reset_counts(bt)
    res = m.eval_policy(args, env, policy, n_episodes=NEW_EPISODES, ep_len=ticks, seed=0,
                        device="cuda")
    res["counts"] = path_counts(bt, policy, before)
    res["launches_per_tick"] = res["counts"]["launches"] / ticks
    res["ip_kkt_solves_per_tick"] = res["counts"]["ip_kkt_solves"] / ticks
    res["per_tick"] = per_tick
    res["active_obstacle_share"] = active_share(rows)
    policy.forward = forward
    x = env.reset(torch.Generator().manual_seed(1), NEW_EPISODES, device="cuda")
    with torch.inference_mode():
        res["profiled_tick"] = profiled(bt, lambda: policy.forward(x), f"{ckpt} profiled tick")
    out["closed_loop"] = res
    return out


# the bf16 trunk's one application (input encoder, one cell application, head;
# no fixed-point solve to amplify rounding), card vs CPU, relative norm of
# the gap in z and x_ref. On an H100, served rexquad_deqmpc's 32 start states:
# 8.9e-5 (x_ref) and 1.9e-4 (z), both in bf16 and rounded op by op, the
# products summed in other orders; the card's f32 trunk against the CPU's
# bf16 (planted), which must exceed the limit: 1.9e-3 and 4.0e-3
BF16_TRUNK_TOL = 1e-3


def bf16_trunk_gaps(policy, state, x0):
    """The bf16 network's one application on the served start states: card
    bf16 against CPU bf16, and the card's f32 trunk against CPU bf16 (the
    planted fault). z0 is seeded, the carried trajectory the state tiled."""
    from deqmpc_tpu_torch.models.deq_layer import DEQLayer

    cfg = dataclasses.replace(policy.model.cfg, fp_type="single")
    bsz = x0.shape[0]
    z0 = 0.3 * torch.randn((bsz, cfg.T - 1, cfg.hdim), generator=torch.Generator().manual_seed(2))
    outs = {}
    for name, dev, dt in (("card", "cuda", cfg.compute_dtype), ("cpu", "cpu", cfg.compute_dtype),
                          ("card_f32", "cuda", None)):
        layer = DEQLayer(dataclasses.replace(cfg, compute_dtype=dt)).to(dev)
        layer.load_state_dict({k: v.to(dev) for k, v in state.items()})
        x = x0.to(dev, torch.float32)
        with torch.no_grad():
            o, z = layer(x, x[:, None].expand(bsz, cfg.T, cfg.nx).contiguous(), z0.to(dev))
        outs[name] = {"x_ref": o["x_ref"].double().cpu(), "z": z.double().cpu()}

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    return {f"{key}_{what}": rel(outs[what][key], outs["cpu"][key])
            for key in ("x_ref", "z") for what in ("card", "card_f32")}


def check_served(sv, ckpt):
    """The checks of a served configuration (`serve_config`): tick 0 card vs
    CPU within ACTION_TOL, every planted fault rejected, a finite closed
    loop, every solve through the warp kernel (with the interior-point
    solve: no block-tridiagonal solve, dense solves every tick)."""
    # with bf16 matmuls the f64 policy still rounds them to bf16: its tick 0
    # is printed, held by the f32 limits and the trunk check
    for dtype in (torch.float32,) if "bf16_trunk" in sv else (torch.float32, torch.float64):
        check(gap_within(sv["gaps"][str(dtype)], dtype),
              f"{ckpt} tick-0 actions, card vs CPU ({dtype}): {sv['gaps'][str(dtype)]} "
              f"beyond {ACTION_TOL[dtype]}")
    check(sv["planted"], f"{ckpt}: no planted fault")
    if "bf16_trunk" in sv:
        g = sv["bf16_trunk"]
        check(all(g[f"{k}_card"] < BF16_TRUNK_TOL < g[f"{k}_card_f32"] for k in ("x_ref", "z")),
              f"{ckpt}: bf16 trunk card vs CPU beyond {BF16_TRUNK_TOL}, or the f32 trunk "
              f"(planted) within it: {g}")
    for name, p in sv["planted"].items():
        dtype = torch.float32 if p["dtype"] == str(torch.float32) else torch.float64
        check(not gap_within(p["gap"], dtype),
              f"{ckpt}: the tick-0 check passed a planted fault ({name}): {p['gap']}")
    cl = sv["closed_loop"]
    check(cl["n_nan_episodes"] == 0 and np.isfinite(cl["mean_reward"]),
          f"{ckpt}: non-finite states or rewards in the closed loop")
    if sv["mode"]["solver_type"] == "ip":
        check(cl["counts"]["launches"] == 0 and cl["counts"]["newton_steps"] == 0
              and all(t["ip_kkt_solves"] > 0 for t in cl["per_tick"])
              and cl["profiled_tick"]["dense_linalg_launches"] > 0,
              f"{ckpt} closed loop with the interior-point solve: {cl['counts']}, profiled "
              f"{cl['profiled_tick']}")
    else:
        check_all_warp(cl["counts"], f"{ckpt} closed loop")


def action_gap(u_card, u_cpu):
    gap = (u_card.double().cpu() - u_cpu.double()).abs().amax(dim=-1)
    return {"median": float(gap.median()), "p75": float(gap.quantile(0.75)),
            "max": float(gap.max())}


def gap_within(gap, dtype, tol=ACTION_TOL):
    return all(gap[q] <= lim for q, lim in tol[dtype].items())


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


class Ctx(types.SimpleNamespace):
    """What every phase uses: the port's modules, and the config-#4
    checkpoint (the served rexquad, the env of configs #4 and #5)."""

    @staticmethod
    def make():
        from deqmpc_tpu_torch import data
        from deqmpc_tpu_torch.envs import make_env, make_env_of
        from deqmpc_tpu_torch.ops import block_tridiag, tridiag
        from deqmpc_tpu_torch.policies import DEQMPCPolicy, PolicyCarry, build_policy
        from deqmpc_tpu_torch.solvers import newton_al
        from deqmpc_tpu_torch.solvers.al_core import obstacle_residuals
        from deqmpc_tpu_torch.training import bench_streaming, train
        from deqmpc_tpu_torch.training.eval import card_info, eval_policy
        from deqmpc_tpu_torch.utils.checkpoint import load_checkpoint

        c = Ctx(data=data, make_env=make_env, make_env_of=make_env_of, bt=block_tridiag,
                tridiag=tridiag,
                DEQMPCPolicy=DEQMPCPolicy, PolicyCarry=PolicyCarry, build_policy=build_policy,
                newton_al=newton_al, obstacle_residuals=obstacle_residuals,
                bench_streaming=bench_streaming, train=train, card_info=card_info,
                eval_policy=eval_policy, load_checkpoint=load_checkpoint,
                build_obstacles=train.build_obstacles)
        c.state, c.args = load_checkpoint(CKPT, "cuda")
        c.env = make_env(c.args["env"])
        return c

    def expert_batch(self, env_name, env, seed, horizon, teacher="mpc", H=1):
        """A seeded bsz-TRAIN_BSZ batch of expert windows (H-step histories)
        through the port's pipeline."""
        gt, _ = self.train.split_episodes(self.data.get_gt_data(env, teacher))
        return self.train.preprocess_batch(env_name, env.nx, self.data.sample_trajectory(
            gt, TRAIN_BSZ, H, horizon, np.random.default_rng(seed)))


def phase_serve_rexquad(c):
    """Config #4 served: tick 0 card vs CPU, the served Newton systems, a
    planted fault, then EPISODES x TICKS closed-loop ticks."""
    bt, tridiag, newton_al, env, state = c.bt, c.tridiag, c.newton_al, c.env, c.state
    policy = c.build_policy(c.args, env, "cuda")
    policy.model.load_state_dict(state)
    phase("serve: tick 0 on the card vs the CPU", params=sum(
        p.numel() for p in policy.model.parameters()), hdim=policy.cfg.hdim)
    x0 = env.reset(torch.Generator().manual_seed(0), EPISODES, device="cpu")
    gaps, retries, systems = {}, {}, {}

    def first_actions(p, x):
        return p.forward(x)["trajs"][-1][2][:, 0]

    with torch.inference_mode():
        for dtype in (torch.float32, torch.float64):
            pols = {}
            for dev in ("cuda", "cpu"):
                cfg = dataclasses.replace(policy.cfg, solver_dtype=dtype)
                p = c.DEQMPCPolicy(cfg, env, dev)
                p.model.load_state_dict(state)
                p.model.to(dtype)
                pols[dev] = p
            # keep every Newton system the card solves in this forward
            with record_systems(newton_al, limit=None) as rec:
                u = {"cuda": first_actions(pols["cuda"], x0.to("cuda", dtype))}
            systems[dtype] = rec.of_dtype(dtype)
            u["cpu"] = first_actions(pols["cpu"], x0.to("cpu", dtype))
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
    out = {"tick0_action_gap": gaps, "tick0_retries": retries,
           "served_systems": [check_served_systems(bt, tridiag, systems[dtype], dtype)
                              for dtype in (torch.float32, torch.float64)]}
    for dtype in (torch.float32, torch.float64):
        check(gap_within(gaps[str(dtype)], dtype),
              f"tick-0 actions, card vs CPU ({dtype}): {gaps[str(dtype)]} "
              f"beyond {ACTION_TOL[dtype]}")
    check(not gap_within(gaps["planted_fault_O_transposed"], torch.float32),
          "the tick-0 check passed a planted fault (O transposed)")

    phase("serve: closed loop", episodes=EPISODES, ticks=TICKS)
    reset_counts(bt)
    steps0 = policy.newton_steps
    res = c.eval_policy(c.args, env, policy, n_episodes=EPISODES, ep_len=TICKS, seed=0,
                        device="cuda")
    launches = bt.block_tridiag_solve.launches
    by_kernel = dict(bt.block_tridiag_solve.launches_by_kernel)
    newton_steps = policy.newton_steps - steps0
    res.update(launches=launches, launches_by_kernel=by_kernel, newton_steps=newton_steps,
               launches_per_tick=launches / TICKS)
    out["serve"] = res
    phase("serve done", **res)
    check(res["n_nan_episodes"] == 0, "non-finite states in the closed loop")
    check(np.isfinite(res["mean_reward"]), "non-finite reward")
    check(newton_steps > 0 and launches >= newton_steps,
          f"{launches} kernel launches for {newton_steps} Newton steps")
    check(by_kernel["warp"] == launches and by_kernel["block"] == 0,
          f"the served path did not go through the warp kernel alone: {by_kernel}")
    return out, {"launches_by_kernel": by_kernel}


def phase_train_rexquad(c):
    """Config #4 trained from its checkpoint."""
    phase("train: config #4", bsz=TRAIN_BSZ, steps=TRAIN_STEPS)
    tr4 = train_config(c.bt, c.train, c.build_policy, c.newton_al, c.state,
                       c.args, c.env, c.expert_batch(c.args["env"], c.env, 0, c.args["T"]))
    for s_ in tr4["steps"]:
        print(f"[chip_smoke]   step {json.dumps(s_)}", flush=True)
    phase("train: config #4 done", **{k: v for k, v in tr4.items() if k != "steps"})
    check_train(tr4, "config-#4 training")
    return tr4, tr4["counts"]


def phase_train_pendulum(c):
    """Config #1 from a seeded fresh policy."""
    phase("train: config #1", bsz=TRAIN_BSZ, steps=PENDULUM_TRAIN_STEPS)
    penv = c.make_env("pendulum")
    tr1 = train_pendulum(c.bt, c.train, c.build_policy, penv,
                         c.expert_batch("pendulum", penv, 1, c.args["T"]))
    phase("train: config #1 done", **tr1)
    check(all(np.isfinite(tr1["losses"])) and all(np.isfinite(tr1["grad_norms"])),
          f"non-finite loss or gradient norm: {tr1}")
    check(tr1["losses"][-1] < tr1["losses"][0], f"the loss did not fall: {tr1['losses']}")
    check_all_warp(tr1["counts"], "config-#1 training")
    check(tr1["counts"]["backward_solves"] == PENDULUM_TRAIN_STEPS * tr1["deq_iter"],
          f"{tr1['counts']['backward_solves']} backward solves in {PENDULUM_TRAIN_STEPS} steps")
    return tr1, tr1["counts"]


def phase_serve_pendulum(c):
    """`pendulum_deqmpc` in closed loop."""
    phase("serve: pendulum closed loop", episodes=PENDULUM_EPISODES, ticks=PENDULUM_TICKS)
    sp = serve_pendulum(c.bt, c.newton_al, c.build_policy, c.load_checkpoint, c.make_env,
                        c.eval_policy)
    phase("serve: pendulum done", **sp)
    check(sp["n_nan_episodes"] == 0 and np.isfinite(sp["mean_reward"]),
          "non-finite states or rewards in the pendulum closed loop")
    check(sp["block_sizes"] == [3], f"pendulum solves at block sizes {sp['block_sizes']}")
    check_all_warp(sp["counts"], "pendulum closed loop")
    return sp, sp["counts"]


def phase_serve_streaming(c):
    """`rexquad_streaming` (config #5) served warm-started."""
    phase("serve: rexquad_streaming warm-started", states=STREAM_STATES,
          warm_ticks=STREAM_WARM_TICKS, episodes=STREAM_EPISODES, ticks=STREAM_TICKS)
    ss = serve_streaming(c.bt, c.tridiag, c.newton_al, c.DEQMPCPolicy, c.PolicyCarry,
                         c.build_policy, c.load_checkpoint, c.make_env, c.eval_policy)
    cl = ss["closed_loop"]
    phase("serve: rexquad_streaming done", **{k: v for k, v in cl.items() if k != "per_tick"})
    for row in cl["per_tick"]:
        print(f"[chip_smoke]   tick {json.dumps(row)}", flush=True)
    for dtype in (torch.float32, torch.float64):
        for t, g in enumerate(ss["gaps"][str(dtype)]):
            tol = ACTION_TOL if t == 0 else WARM_ACTION_TOL
            check(gap_within(g, dtype, tol), f"streaming tick {t}, card vs CPU ({dtype}): {g} "
                  f"beyond {tol[dtype]}")
    check(not all(gap_within(g, torch.float64, WARM_ACTION_TOL)
                  for g in ss["gaps"]["planted_unshifted_carry_f64"][1:]),
          "the f64 warm-tick check passed a planted fault (the carry left unshifted)")
    check(cl["n_nan_episodes"] == 0 and np.isfinite(cl["mean_reward"]),
          "non-finite states or rewards in the streaming closed loop")
    check(cl["warm_start"] and [r["kind"] for r in cl["per_tick"]]
          == ["cold"] + ["warm"] * (STREAM_TICKS - 1), "the closed loop was not warm-started")
    check_all_warp(cl["counts"], "streaming closed loop")
    return ss, cl["counts"]


def phase_train_streaming(c):
    """Config #5's streaming step from `rexquad_streaming`."""
    state5, args5 = c.load_checkpoint(STREAMING_CKPT, "cuda")
    L = args5["streaming_steps"]
    phase("train: config #5 (streaming)", bsz=TRAIN_BSZ, steps=TRAIN_STEPS, streaming_steps=L)
    tr5 = train_config(c.bt, c.train, c.build_policy, c.newton_al, state5, args5,
                       c.env, c.expert_batch(args5["env"], c.env, 2, args5["T"] + L),
                       loss=c.train.make_loss_fn(L), sensitivity=False)
    for s_ in tr5["steps"]:
        print(f"[chip_smoke]   step {json.dumps(s_)}", flush=True)
    phase("train: config #5 done", **{k: v for k, v in tr5.items() if k != "steps"})
    # one implicit backward per round of each of the 1 + L forwards
    check_train(tr5, "config-#5 training", forwards=1 + L)
    return tr5, tr5["counts"]


def phase_serve_new(ckpt, args_update=None, ticks=NEW_TICKS):
    """Serve config #2, #3 or #3b, a diff-mpc arm, or a checkpoint with
    `args_update` (`serve_config`), `ticks` closed-loop ticks."""
    def run(c):
        phase(f"serve: {ckpt}", episodes=NEW_EPISODES, ticks=ticks, **(args_update or {}))
        sv = serve_config(ckpt, c.bt, c.tridiag, c.newton_al, c, args_update, ticks=ticks)
        cl = sv["closed_loop"]
        for row in cl["per_tick"]:
            print(f"[chip_smoke]   tick {json.dumps(row)}", flush=True)
        phase(f"serve: {ckpt} done", **{k: v for k, v in cl.items() if k != "per_tick"})
        check_served(sv, ckpt)
        return sv, cl["counts"]
    return run


def phase_train_new(ckpt, teacher, args_update=None):
    """Train config #2 or #3, or the diff-mpc arm of #3, from its checkpoint
    on its teacher's data, its args updated by `args_update` (#3 with
    `Qscale` 2)."""
    def run(c):
        state, args = c.load_checkpoint(ckpt, "cuda")
        args = {**args, **(args_update or {})}
        env = c.make_env_of(args)
        phase(f"train: {ckpt}", bsz=TRAIN_BSZ, steps=TRAIN_STEPS, teacher=teacher,
              **(args_update or {}))
        tr = train_config(c.bt, c.train, c.build_policy, c.newton_al, state, args,
                          env, c.expert_batch(args["env"], env, 3, args["T"], teacher),
                          sensitivity=False)
        for s_ in tr["steps"]:
            print(f"[chip_smoke]   step {json.dumps(s_)}", flush=True)
        phase(f"train: {ckpt} done", **{k: v for k, v in tr.items() if k != "steps"})
        check_train(tr, f"{ckpt} training")
        return tr, tr["counts"]
    return run


# the interior-point training path's first QP, card vs CPU in f64, relative
# to each tensor's largest entry: the qp_layer backward's six input
# gradients, and the QP's solution (z, s, lam, nu; 5.3e-15 on an H100,
# 0.52 at 2 iterations)
QP_LAYER_RTOL = 1e-6
QP_SOLVE_RTOL = 1e-9


def qp_layer_on_path(policy, obs, pdipm, ip_mpc):
    """The first round's qp_layer call in the policy's forward from `obs`,
    captured and run again on the card and on the CPU in f64: its solution
    (z, s, lam, nu) through `qp_solve` with the path's iterations, and with
    2 iterations on the card (a planted fault); and the six input gradients
    for a seeded cotangent, and with the pull-back's sign flipped on the
    card (a planted fault). The step's gradient cannot show the layer's
    backward on this path: its controls sit on the box bound, and the
    solver path is 1.8e-6 of the config-#1 gradient's norm (f64, CPU)."""
    captured, layer = [], ip_mpc.qp_layer

    def keep(*a):
        captured.append(([t.detach().double().cpu() for t in a[:6]], a[6]))
        return layer(*a)

    ip_mpc.qp_layer = keep
    try:
        with torch.no_grad():
            policy.forward(obs)
    finally:
        ip_mpc.qp_layer = layer
    qp, iters = captured[0]
    gz = torch.randn(qp[1].shape, generator=torch.Generator().manual_seed(0), dtype=torch.float64)

    def solution(dev, n_iters=iters):
        sol = pdipm.qp_solve(*[a.to(dev) for a in qp], n_iters)
        return [t.cpu() for t in sol[:4]]

    def grads(dev):
        t = [a.to(dev, copy=True).requires_grad_() for a in qp]
        z = pdipm.qp_layer(*t, iters)
        z.backward(gz.to(dev))
        return [a.grad.cpu() for a in t]

    card, cpu = grads("cuda"), grads("cpu")
    undo = flip_qp_layer_backward(pdipm)
    try:
        bad = grads("cuda")
    finally:
        undo()

    def gap(a, b):
        return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-300)
                   for x, y in zip(a, b))

    sol_cpu = solution("cpu")
    return {"shapes": {k: list(v.shape) for k, v in zip("Q p G h A b".split(), qp)},
            "iters": iters, "solution_rel_gap_card_vs_cpu": gap(solution("cuda"), sol_cpu),
            "solution_rel_gap_planted_2_iters": gap(solution("cuda", 2), sol_cpu),
            "rel_gap_card_vs_cpu": gap(card, cpu), "rel_gap_planted_sign_flip": gap(bad, cpu),
            "largest": {k: float(v.abs().max()) for k, v in zip("Q p G h A b".split(), cpu)}}


def phase_train_ip(c):
    """Config #1 with the interior-point solve, from a seeded fresh policy:
    step 0 card vs CPU in f64, TRAIN_STEPS steps, and the path's first QP
    card vs CPU: its solution (2 iterations in place of the path's
    rejected) and the qp_layer backward (a sign flip of its pull-back
    rejected)."""
    from deqmpc_tpu_torch.solvers import ip_mpc, pdipm

    argv = ["--env", "pendulum", "--model_type", "deq-mpc-deq", "--T", "5", "--deq_iter", "6",
            "--hdim", "256", "--bsz", str(TRAIN_BSZ), "--solver_type", "ip"]
    args = vars(c.train.parse_args(argv))
    env = c.make_env("pendulum")
    state = c.build_policy(args, env, "cpu").init(0).model.state_dict()
    batch_np = c.expert_batch("pendulum", env, 4, args["T"])
    phase("train: config #1, interior-point solve", bsz=TRAIN_BSZ, steps=TRAIN_STEPS)
    tr = train_config(c.bt, c.train, c.build_policy, c.newton_al, state, args,
                      env, batch_np, sensitivity=False, planted=False)
    for s_ in tr["steps"]:
        print(f"[chip_smoke]   step {json.dumps(s_)}", flush=True)
    pol = c.build_policy(args, env, "cuda")
    pol = c.DEQMPCPolicy(dataclasses.replace(pol.cfg, solver_dtype=torch.float64), env, "cuda")
    pol.model.load_state_dict(state)
    pol.model.double()
    obs = torch.as_tensor(batch_np["obs"][:, -1], dtype=torch.float64, device="cuda")
    tr["qp_layer_on_path"] = layer = qp_layer_on_path(pol, obs, pdipm, ip_mpc)
    phase("train: config #1, interior-point solve done",
          **{k: v for k, v in tr.items() if k != "steps"})
    check_train(tr, "config-#1 interior-point training", dtypes=(torch.float64,))
    check(layer["rel_gap_card_vs_cpu"] <= QP_LAYER_RTOL < layer["rel_gap_planted_sign_flip"],
          f"qp_layer backward on the interior-point path, card vs CPU: {layer}")
    check(layer["solution_rel_gap_card_vs_cpu"] <= QP_SOLVE_RTOL
          < layer["solution_rel_gap_planted_2_iters"],
          f"the interior-point path's QP solution, card vs CPU: {layer}")
    return tr, tr["counts"]


class NoPlusOne:
    """The Q variant's planted fault: the tracking cost scaled by Q * q in
    place of Q * (q + 1)."""

    def __init__(self, tm):
        self.tm = tm

    def __call__(self, *a, q_scaling=None, **kw):
        return self.tm(*a, q_scaling=None if q_scaling is None else q_scaling - 1, **kw)

    def __getattr__(self, name):
        return getattr(self.tm, name)


def plant_product_rule(p):
    """The delta's planted fault: `scale_multiply_st` by the product rule."""
    from deqmpc_tpu_torch.models import deq_layer_variants as dv

    good = dv.scale_multiply_st
    dv.scale_multiply_st = lambda x, s_: x * s_
    return lambda: setattr(dv, "scale_multiply_st", good)


def plant_no_plus_one(p):
    """The Q variant's planted fault: the cost scaled without its +1."""
    tm = p.tracking_mpc
    p.tracking_mpc = NoPlusOne(tm)
    return lambda: setattr(p, "tracking_mpc", tm)


def plant_x0_row(p):
    """estpred's planted fault: the estimator with the initial-state row and
    the control box (`state_estimator=False`)."""
    from deqmpc_tpu_torch.policies import TrackingMPC

    est, cfg = p.state_estimator, p.cfg
    p.state_estimator = TrackingMPC(p.env, p.H, al_iter=cfg.al_iter, state_estimator=False,
                                    dtype=cfg.solver_dtype, rho_max=cfg.rho_max, device=p.device)
    return lambda: setattr(p, "state_estimator", est)


# the planted faults of a variant's f64 step 0, which STEP0_RTOL must reject;
# estpred's is held by its estimates (`estimate_gaps`)
VARIANT_FAULTS = {"delta": [("scale_multiply_product_rule", plant_product_rule)],
                  "q": [("q_scaling_without_plus_one", plant_no_plus_one)]}


def estimate_gaps(c, args, env, state, batch_np):
    """estpred's f64 forward on the step-0 batch, card vs CPU: every round's
    state estimates after the MHE estimator, per sample the largest gap,
    held by the f64 ACTION_TOL; and the same with the estimator given the
    initial-state row on the card (a planted fault it must reject)."""
    def estimates(dev, plant=None):
        p = policy_in(c.build_policy, args, env, dev, torch.float64)
        p.model.load_state_dict({k: v.to(dev) for k, v in state.items()})
        undo = plant(p) if plant is not None else None
        b = c.train.to_device(batch_np, dev, torch.float64)
        try:
            with torch.inference_mode():
                out = p.forward(b["obs"], b["obs_action"])
        finally:
            if undo is not None:
                undo()
        return torch.cat([post.flatten(1) for _, post in out["nominal_x_ests"]], dim=1)

    cpu = estimates("cpu")
    return {"gap_card_vs_cpu_f64": action_gap(estimates("cuda"), cpu),
            "planted_estimator_with_x0_row": action_gap(estimates("cuda", plant_x0_row), cpu)}


def mhe_systems(c, policy, batch_np):
    """One f32 forward of estpred on the card with every solve of the
    estimator's shape kept: the estimator's Newton steps and jittered
    retries, the share of its samples whose first solve came back NaN, and
    its systems (first solves and retries) held against the plain solve."""
    from deqmpc_tpu_torch.solvers.newton_al import NewtonCounts

    est = policy.state_estimator.ctrl.newton
    shared, est.counts = est.counts, NewtonCounts()
    kept, solve = [], c.newton_al.block_tridiag_solve

    def keep(D, O, b):
        x = solve(D, O, b)
        if D.shape[1] == VARIANT_H:
            kept.append((b.clone(), D.clone(), O.clone(), bool(torch.isnan(x).any())))
        return x

    c.newton_al.block_tridiag_solve = keep
    b = c.train.to_device(batch_np, "cuda")
    try:
        with torch.inference_mode():
            policy.forward(b["obs"], b["obs_action"])
    finally:
        c.newton_al.block_tridiag_solve = solve
        counts, est.counts = est.counts, shared
    first = [k for k in kept[:1]] + [k for prev, k in zip(kept, kept[1:]) if not prev[3]]
    nan_samples = sum(int(torch.isnan(c.tridiag.block_tridiag_solve(D, O, g)).flatten(1)
                          .any(dim=1).sum()) for g, D, O, _ in first)
    out = {"newton_steps": counts.steps, "retries": counts.retries, "solves": len(kept),
           "first_solve_nan_share": nan_samples / max(sum(D.shape[0] for _, D, _, _ in first), 1)}
    out["kernel_vs_plain"] = check_served_systems(c.bt, c.tridiag,
                                                  [k[:3] for k in kept], torch.float32)
    return out


# ROADMAP C5: the feedback variant's f64 step 0 on the card, beside the
# card's own move under as many 1e-14 moves of the observations as the CPU
# test made first (4; JAX's 16 are in `tests/test_torch_variants_c5.py`)
C5_MOVES = 4


def phase_train_variant(name):
    """A policy variant trained on config #1 (pendulum, full width, bsz
    TRAIN_BSZ) from a seeded fresh init, as config #4 (`train_config`):
    step 0 card vs CPU (f64 loss and gradient norm within STEP0_RTOL, the
    sign flip and the variant's own planted fault rejected; the delta's
    scales after the step), TRAIN_STEPS steps, all warp, one profiled step;
    for estpred also the estimator's systems (`mhe_systems`)."""
    def run(c):
        args = vars(c.train.parse_args(["--env", "pendulum", "--T", "5", "--deq_iter", "6",
                                        "--hdim", "256", "--bsz", str(TRAIN_BSZ),
                                        *VARIANT_FLAGS[name]]))
        env = c.make_env("pendulum")
        state = c.build_policy(args, env, "cpu").init(5).model.state_dict()
        batch_np = c.expert_batch("pendulum", env, 5, args["T"], H=args["H"])
        phase(f"train: variant {name}", bsz=TRAIN_BSZ, steps=TRAIN_STEPS, H=args["H"])
        tr = train_config(c.bt, c.train, c.build_policy, c.newton_al, state,
                          args, env, batch_np, sensitivity=False,
                          faults=VARIANT_FAULTS.get(name, ()),
                          moves=C5_MOVES if name == "feedback" else 0)
        tr["variant"] = type(c.build_policy(args, env, "cpu")).__name__
        if name == "mem":  # the --addmem alias built what --policy_variant mem builds
            named = c.build_policy({**args, "addmem": False, "policy_variant": "mem"}, env,
                                   "cpu")
            check(tr["variant"] == type(named).__name__ == "DEQMPCPolicyMem",
                  f"--addmem built {tr['variant']}")
        if name == "estpred":
            pol = policy_in(c.build_policy, args, env, "cuda", torch.float32)
            pol.model.load_state_dict({k: v.cuda() for k, v in state.items()})
            tr["mhe"] = mhe_systems(c, pol, batch_np)
            tr["estimates"] = estimate_gaps(c, args, env, state, batch_np)
        for s_ in tr["steps"]:
            print(f"[chip_smoke]   step {json.dumps(s_)}", flush=True)
        phase(f"train: variant {name} done", **{k: v for k, v in tr.items() if k != "steps"})
        # estpred: the estimator's backward too, in every round but the last
        n = tr["deq_iter"]
        check_train(tr, f"variant {name} training", backward=2 * n - 1 if name == "estpred"
                    else n)
        check(len(tr.get("planted_f64", {})) == len(VARIANT_FAULTS.get(name, ())),
              f"variant {name}: planted faults {tr.get('planted_f64')}")
        if name == "estpred":
            est = tr["estimates"]
            check(gap_within(est["gap_card_vs_cpu_f64"], torch.float64)
                  and not gap_within(est["planted_estimator_with_x0_row"], torch.float64),
                  f"estpred's estimates (f64), card vs CPU, and with the x0 row planted: {est}")
        if name == "delta":
            gap = tr["delta_scales_after_step0_f64_max_abs_gap"]
            check(gap <= DELTA_SCALES_TOL,
                  f"delta scales after step 0 (f64), card vs CPU: {gap} > {DELTA_SCALES_TOL}")
        return tr, tr["counts"]
    return run


def phase_serve_variant(name):
    """A variant that JAX's eval serves, trained for one step by the train
    CLI on the card, which writes its port checkpoint; that checkpoint
    served as configs #2-#3b are (`serve_config`), VARIANT_TICKS ticks."""
    def run(c):
        phase(f"serve: variant {name}", episodes=NEW_EPISODES, ticks=VARIANT_TICKS)
        with tempfile.TemporaryDirectory(prefix="smoke_ckpt_", dir=".") as tmp:
            argv = ["--env", "pendulum", "--T", "5", "--deq_iter", "6", "--hdim", "256",
                    "--bsz", "32", "--max_train_steps", "1", "--val_every", "1", "--save",
                    "--name", name, "--models_dir", tmp, "--logdir", f"{tmp}/logs",
                    *VARIANT_FLAGS[name]]
            trained = c.train.main(argv)
            check(trained["checkpoint"] and trained["policy_variant"] == name,
                  f"variant {name}: the train CLI wrote {trained['checkpoint']}")
            # O transposed held by the f64 check: on these policies' pendulum
            # systems it moved the f32 median by 0.046 (hdim 32), under f32's 0.05
            sv = serve_config(f"{tmp}/{name}", c.bt, c.tridiag, c.newton_al, c,
                              ticks=VARIANT_TICKS, o_transposed_dtype=torch.float64)
        cl = sv["closed_loop"]
        for row in cl["per_tick"]:
            print(f"[chip_smoke]   tick {json.dumps(row)}", flush=True)
        phase(f"serve: variant {name} done", **{k: v for k, v in cl.items() if k != "per_tick"})
        check_served(sv, f"variant {name}")
        return sv, cl["counts"]
    return run


def plant_one_step_adjoint(p):
    """The implicit backward's planted fault: the transpose fixed point
    replaced by w = g (the one-step gradient)."""
    from deqmpc_tpu_torch.models import deq_layer

    good = deq_layer.adjoint_solve
    deq_layer.adjoint_solve = lambda vjp_z, g, solver, kw: g
    return lambda: setattr(deq_layer, "adjoint_solve", good)


def plant_refresh_dropped(p):
    """The cost refresh's planted fault: the plain solve, no refresh."""
    cfg = p.cfg
    p.cfg = dataclasses.replace(cfg, recompute_Qq=False)
    return lambda: setattr(p, "cfg", cfg)


def phase_train_rexquad_with(name, update, faults, planted, backward):
    """Config #4 from its checkpoint with `update` in its args (the true
    DEQ gradient, or the cost refresh), as config #4 (`train_config`): the
    f64 step 0 card vs CPU, the planted `faults` (and, with `planted`, the
    sign flip) rejected by it, TRAIN_STEPS steps with their solves and
    solver stats, one profiled step; `backward` implicit-backward solves a
    step."""
    def run(c):
        args = {**c.args, **update}
        phase(f"train: config #4 {name}", bsz=TRAIN_BSZ, steps=TRAIN_STEPS, **update)
        tr = train_config(c.bt, c.train, c.build_policy, c.newton_al, c.state, args, c.env,
                          c.expert_batch(args["env"], c.env, 0, args["T"]), sensitivity=False,
                          planted=planted, faults=faults)
        for s_ in tr["steps"]:
            print(f"[chip_smoke]   step {json.dumps(s_)}", flush=True)
        phase(f"train: config #4 {name} done", **{k: v for k, v in tr.items() if k != "steps"})
        check_train(tr, f"config-#4 {name} training", backward=backward)
        check(len(tr.get("planted_f64", {})) == len(faults), f"{name}: planted {tr}")
        check(all(len(s_["deq_fwd_err"]) == tr["deq_iter"] for s_ in tr["steps"]),
              f"{name}: the rounds' solver stats are missing")
        return tr, tr["counts"]
    return run


# config #1 from a seeded fresh init with the fixed-point, dtype and
# coefficient options of the train CLI
SLICE8_FLAGS = {"broyden": ["--fp_type", "broyden"],
                "broyden_implicit": ["--fp_type", "broyden", "--grad_type", "implicit"],
                "multi_last_step": ["--fp_type", "multi", "--grad_type", "last_step_grad"],
                "multi_bptt": ["--fp_type", "multi"],
                "bf16": ["--compute_dtype", "bf16"],
                "grad_coeff": ["--grad_coeff", "--val_every", "1"]}


def phase_train_slice8(name):
    """Config #1 (pendulum, full width, bsz TRAIN_BSZ) from a seeded fresh
    init under one of SLICE8_FLAGS, as config #4 (`train_config`): step 0
    card vs CPU, the sign flip rejected, TRAIN_STEPS steps with their solver
    stats; with --grad_coeff the ratios at the starting weights card vs CPU
    in f64 (within the f64 gradient-norm limit) and the coefficients after
    each step. The
    bf16 step is held in f32 only (in f64 its matmuls still round to bf16)."""
    def run(c):
        args = vars(c.train.parse_args(["--env", "pendulum", "--T", "5", "--deq_iter", "6",
                                        "--hdim", "256", "--bsz", str(TRAIN_BSZ),
                                        *SLICE8_FLAGS[name]]))
        env = c.make_env("pendulum")
        state = c.build_policy(args, env, "cpu").init(7).model.state_dict()
        phase(f"train: slice 8 {name}", bsz=TRAIN_BSZ, steps=TRAIN_STEPS)
        bf16 = name == "bf16"
        tr = train_config(c.bt, c.train, c.build_policy, c.newton_al, state, args, env,
                          c.expert_batch("pendulum", env, 7, args["T"]), sensitivity=False,
                          planted=not bf16, grad_coeff=args["grad_coeff"])
        for s_ in tr["steps"]:
            print(f"[chip_smoke]   step {json.dumps(s_)}", flush=True)
        phase(f"train: slice 8 {name} done", **{k: v for k, v in tr.items() if k != "steps"})
        n = tr["deq_iter"]
        # with the coefficients, each step's ratios add round j's probe of
        # rounds 0..j to the step's n backward solves
        check_train(tr, f"slice-8 {name} training",
                    dtypes=(torch.float32,) if bf16 else (torch.float32, torch.float64),
                    backward=n + (n * (n + 1) // 2 if args["grad_coeff"] else 0))
        multi = args["fp_type"] == "multi"
        check(all(("deq_fwd_err" in s_) != multi for s_ in tr["steps"]),
              f"slice-8 {name}: solver stats {tr['steps']}")
        if args["grad_coeff"]:
            gap = tr["step0_ratios_gap_card_vs_cpu_f64"]
            check(gap <= STEP0_RTOL[torch.float64]["grad_norm"],
                  f"slice-8 {name}: step-0 ratios (f64), card vs CPU: {gap}")
            check(all(np.isfinite(s_["coeffs"]).all() for s_ in tr["steps"]),
                  f"slice-8 {name}: coefficients {tr['steps']}")
        return tr, tr["counts"]
    return run


class record_systems:
    """Within the block, what every NewtonAL of the port solves, by (shape
    of the right-hand side, dtype): the first `limit` Newton systems
    (g, D, O) of each key, cloned (`systems`; every one with `limit` None),
    and the count of block-tridiagonal solves, forward and backward,
    retries included (`solves`; its keys are `shapes`)."""

    def __init__(self, newton_al, limit=0):
        self.module, self.limit, self.systems, self.solves = newton_al, limit, {}, {}

    @property
    def shapes(self):
        return set(self.solves)

    def solve_counts(self):
        """`solves` with keys a JSON line can hold."""
        return {f"{list(k[0])}/{k[1].replace('torch.', '')}": n for k, n in self.solves.items()}

    def of_dtype(self, dtype):
        return [s for (_, d), kept in self.systems.items() if d == str(dtype) for s in kept]

    def __enter__(self):
        cls, module = self.module.NewtonAL, self.module
        newton_solve = self.newton_solve = cls._solve_newton_system
        bt_solve = self.bt_solve = module.block_tridiag_solve

        def record(newton, g, D, O):
            kept = self.systems.setdefault((tuple(g.shape), str(g.dtype)), [])
            if self.limit is None or len(kept) < self.limit:
                kept.append((g.clone(), D.clone(), O.clone()))
            return newton_solve(newton, g, D, O)

        def count(D, O, b):
            key = (tuple(b.shape), str(b.dtype))
            self.solves[key] = self.solves.get(key, 0) + 1
            return bt_solve(D, O, b)

        cls._solve_newton_system, module.block_tridiag_solve = record, count
        return self

    def __exit__(self, *exc):
        self.module.NewtonAL._solve_newton_system = self.newton_solve
        self.module.block_tridiag_solve = self.bt_solve


def check_warp_only(counts, what):
    """Every launch through the warp kernel, where the path's solves are not
    counted apart (a CLI that builds its own policy)."""
    by = counts["launches_by_kernel"]
    check(counts["launches"] > 0 and by["warp"] == counts["launches"] and by["block"] == 0,
          f"{what}: not every solve went through the warp kernel: {counts}")


def phase_train_rexquad_double(c):
    """Config #4 from its checkpoint with the args `--dtype double` sets: the
    solver in f64 at rho_max 1e8, the network in f32; as config #4
    (`train_config`): step 0 card vs CPU (the f32 network's loss; the whole
    policy in f64, loss and gradient norm), the sign flip rejected by the
    f64 check, TRAIN_STEPS steps, every solve through the warp kernel at
    (TRAIN_BSZ, 5, 16) f64, 6 backward solves a step."""
    args = {**c.args, "dtype": "double", "rho_max": None}
    phase("train: config #4 --dtype double", bsz=TRAIN_BSZ, steps=TRAIN_STEPS)
    with record_systems(c.newton_al) as rec:
        tr = train_config(c.bt, c.train, c.build_policy, c.newton_al, c.state, args, c.env,
                          c.expert_batch(args["env"], c.env, 0, args["T"]), sensitivity=False)
    shapes = rec.shapes
    tr["solve_shapes"] = sorted(shapes)
    for s_ in tr["steps"]:
        print(f"[chip_smoke]   step {json.dumps(s_)}", flush=True)
    phase("train: config #4 --dtype double done",
          **{k: v for k, v in tr.items() if k != "steps"})
    check_train(tr, "config-#4 --dtype double training", backward=6)
    check(shapes == {((TRAIN_BSZ, 5, 16), "torch.float64")},
          f"--dtype double: solves at {sorted(shapes)}")
    return tr, tr["counts"]


# the train CLI on config #1 with the flags slice 9 ported. optax's cosine
# decay refuses max_train_steps <= 200 (its decay_steps less the 200 warmup
# steps must be positive), so the run starts at --start_iter 201: steps
# 202-204, the rate at the optimizer's counts 0-2, not at the loop's index
CLI_FLAGS = ["--env", "pendulum", "--T", "5", "--deq_iter", "6", "--hdim", "256",
             "--bsz", str(TRAIN_BSZ), "--lr_schedule", "cosine", "--data_noise_type", "2",
             "--loss_type", "l2", "--policy_out_type", "2", "--kernel_width", "5",
             "--num_trajs_frac", "0.5", "--start_iter", "201", "--max_train_steps", "205",
             "--val_every", "2", "--save", "--name", "cli"]
CLI_STEPS = (202, 203, 204)


def jax_metric_keys(deq_iter):
    """The scalars of a JAX CLI validation row (`train.py:675-697`)."""
    keys = {"losses/loss_avg", "losses/loss_end", "val_losses/loss_end", "grad_norm",
            "time/per_step"}
    for k in range(deq_iter):
        keys |= {f"losses/loss{k}", f"losses_opt/loss_opt{k}", f"losses_nn/loss_nn{k}",
                 f"deq_stats/fwd_err{k}", f"deq_stats/fwd_steps{k}"}
    return keys


def phase_train_pendulum_cli(c):
    """Config #1 at full width from a fresh init through `train.main` with
    CLI_FLAGS, its logdir and models_dir in a temporary directory of the
    checkout: finite losses, metrics.jsonl with JAX's keys, each step's rate
    the schedule's at the optimizer's count, the checkpoint reloaded (its
    kernel-width-5 weights into a policy its args build, its optimizer's
    count), every launch through the warp kernel."""
    from deqmpc_tpu_torch.utils.checkpoint import read_port_checkpoint

    train = c.train
    phase("train: the CLI's slice-9 flags", argv=CLI_FLAGS)
    rates, step = [], train.train_step

    def recording_step(policy, optimizer, batch, **kw):
        rates.append((train.optimizer_updates(optimizer), optimizer.param_groups[0]["lr"]))
        return step(policy, optimizer, batch, **kw)

    with tempfile.TemporaryDirectory(prefix="smoke_ckpt_", dir=".") as tmp:
        argv = [*CLI_FLAGS, "--logdir", f"{tmp}/logs", "--models_dir", f"{tmp}/model"]
        reset_counts(c.bt)
        train.train_step = recording_step
        try:
            res = train.main(argv)
        finally:
            train.train_step = step
        counts = launch_counts(c.bt)
        rows = [json.loads(line) for line in open(f"{tmp}/logs/cli/metrics.jsonl")]
        state, args = c.load_checkpoint(f"{tmp}/model/cli", "cuda")
        blob = read_port_checkpoint(f"{tmp}/model/cli")
        pol = c.build_policy(args, c.make_env_of(args), "cuda")
        pol.model.load_state_dict(state)  # strict: the shapes kernel_width 5 makes
        has_snapshot = os.path.isfile(f"{tmp}/logs/cli/code/deqmpc_tpu_torch/training/train.py")
    sched = train.make_lr_schedule("cosine", 1e-3, 205)
    out = {"curve": res["curve"], "rates": rates, "counts": counts,
           "metrics_steps": [r["step"] for r in rows],
           "optimizer_count": int(next(iter(blob["optimizer"]["state"].values()))["step"]),
           "kernel": list(state["cell.Conv_0.kernel"].shape)}
    phase("train: the CLI's slice-9 flags done", **out)
    check(all(np.isfinite(r[k]) for r in res["curve"]
              for k in ("loss_avg", "loss_end", "val_loss_end", "grad_norm")),
          f"CLI run: non-finite losses {res['curve']}")
    check(res["steps"] == len(CLI_STEPS) and [r["step"] for r in res["curve"]] == [202, 204],
          f"CLI run: steps {res['steps']}, rows {[r['step'] for r in res['curve']]}")
    check(rates == [(k, sched(k)) for k in range(len(CLI_STEPS))],
          f"CLI run: the rates {rates} are not the schedule's at counts 0-2")
    check(out["metrics_steps"] == [202, 204]
          and all(set(r) - {"step"} == jax_metric_keys(6) for r in rows),
          f"CLI run: metrics.jsonl rows {rows}")
    check(has_snapshot and out["kernel"][0] == 5 and out["optimizer_count"] == len(CLI_STEPS)
          and args["lr_schedule"] == "cosine",
          f"CLI run: snapshot {has_snapshot}, checkpoint {out['kernel']}, "
          f"{out['optimizer_count']} updates")
    check_warp_only(counts, "the train CLI")
    return out, counts


PROFILE_STEP_SHAPE = (TRAIN_BSZ, 10, 5)  # profile_step's defaults: cartpole1link, T 10


def phase_profile_step(c):
    """`training/profile_step.py --n_rep 2` at its full-width defaults: the
    four times finite, every solve through the warp kernel at its shape."""
    from deqmpc_tpu_torch.training import profile_step

    phase("profile_step", n_rep=2)
    reset_counts(c.bt)
    with record_systems(c.newton_al) as rec:
        out = profile_step.main(["--n_rep", "2"])
    counts, shapes = launch_counts(c.bt), rec.shapes
    out.update(counts=counts, solve_shapes=sorted(shapes))
    phase("profile_step done", **out)
    times = ("network_fwd_ms", "full_fwd_ms", "loss_overhead_ms", "train_step_ms")
    check(all(np.isfinite(out[k]) for k in times) and out["train_step_ms"] > 0
          and (out["env"], out["T"], out["bsz"], out["hdim"]) == ("cartpole1link", 10,
                                                                   TRAIN_BSZ, 256),
          f"profile_step: {out}")
    check(shapes == {(PROFILE_STEP_SHAPE, "torch.float32")},
          f"profile_step: solves at {sorted(shapes)}")
    check_warp_only(counts, "profile_step")
    return out, counts


X_WINDOW = [0.5, 0.5, 0.5] + [0.2] * 3 + [0.3] * 6  # rexquad's start half-widths, Euler space
SENSITIVITY_BSZ = 32


def phase_eval_x_window(c):
    """`rexquad_deqmpc` through `train.main --eval --eval_x_window`,
    EPISODES x TICKS, its start states inside the window, every solve
    through the warp kernel; then `check_param_sensitivity` on a
    SENSITIVITY_BSZ rexquad batch: finite losses, the base loss card vs CPU
    within STEP0_RTOL (f32)."""
    from deqmpc_tpu_torch.training.eval import check_param_sensitivity, param_set_loss

    a = c.args
    window = ",".join(str(v) for v in X_WINDOW)
    argv = ["--env", a["env"], "--nq", str(a["nq"]), "--T", str(a["T"]), "--deq_iter",
            str(a["deq_iter"]), "--hdim", str(a["hdim"]), "--load", "--models_dir",
            "checkpoints", "--ckpt", "rexquad_deqmpc", "--eval", "--eval_episodes",
            str(EPISODES), "--eval_ep_len", str(TICKS), "--eval_x_window", window]
    phase("eval: rexquad_deqmpc --eval_x_window", episodes=EPISODES, ticks=TICKS, window=window)
    cls, starts = type(c.env), []
    reset = cls.reset

    @functools.wraps(reset)  # the CLI reads the signature for x_window
    def recording_reset(self, *args_, **kw):
        x = reset(self, *args_, **kw)
        starts.append((kw.get("x_window"), x.detach().cpu().double()))
        return x

    reset_counts(c.bt)
    cls.reset = recording_reset
    try:
        stats = c.train.main(argv)
    finally:
        cls.reset = reset
    counts = launch_counts(c.bt)
    (got_window, x0), = starts
    w = torch.as_tensor(X_WINDOW, dtype=torch.float64)
    inside = bool((x0[:, :3].abs() <= w[:3]).all() and (x0[:, 6:].abs() <= w[6:]).all())
    batch = {k: v[:SENSITIVITY_BSZ] for k, v in c.expert_batch(a["env"], c.env, 2,
                                                                  a["T"]).items()}
    pol = c.build_policy(a, c.env, "cuda")
    pol.model.load_state_dict(c.state)
    sens = check_param_sensitivity(a, c.env, pol, batch)
    cpu = c.build_policy(a, c.env, "cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in c.state.items()})
    base_cpu = param_set_loss(a, cpu, batch)
    out = {**stats, "counts": counts, "starts_inside": inside,
           "start_abs_max": x0.abs().amax(0).tolist(), "sensitivity": sens,
           "base_loss_cpu": base_cpu,
           "base_loss_gap_card_vs_cpu": rel_gap(sens["base_loss"], base_cpu)}
    phase("eval: rexquad_deqmpc --eval_x_window done", **out)
    check(got_window is not None and list(got_window) == X_WINDOW and inside,
          f"--eval_x_window: the window {got_window}, starts {out['start_abs_max']}")
    check(stats["n_nan_episodes"] == 0 and np.isfinite(stats["mean_reward"]),
          f"--eval_x_window: {stats}")
    check(all(np.isfinite(v) for v in sens.values()) and len(sens) == 4,
          f"check_param_sensitivity: {sens}")
    check(out["base_loss_gap_card_vs_cpu"] <= STEP0_RTOL[torch.float32]["loss"],
          f"check_param_sensitivity: base loss card {sens['base_loss']} vs CPU {base_cpu}")
    check_warp_only(counts, "the eval with --eval_x_window")
    return out, counts


# -- slice 10: the teachers, the golden trajectory, DAgger, SAC, the obstacle protocol --------

def check_path_systems(c, systems, shapes, what):
    """The recorded Newton systems of a path: exactly the expected shapes,
    each held against the plain solve (`check_served_systems`)."""
    check(set(systems) == set(shapes), f"{what}: Newton systems at {sorted(systems)}, "
                                       f"expected {sorted(shapes)}")
    return {f"{list(k[0])}/{k[1]}": check_served_systems(
        c.bt, c.tridiag, v, torch.float64 if "float64" in k[1] else torch.float32)
        for k, v in systems.items()}


def episodes_arrays(eps):
    return (np.stack([[s for s, _ in ep] for ep in eps]),
            np.stack([[a for _, a in ep] for ep in eps]))


def in_box(env, A):
    return bool((A >= env.action_space.low - 1e-5).all() and (A <= env.action_space.high + 1e-5).all())


EXPERT_EPISODES, EXPERT_TICKS = 64, 10  # the MPC teacher at DAgger's settings
EXPERT_SHAPE = (EXPERT_EPISODES, 30, 16)
CARTPOLE_TEACHER_SHAPE = (EXPERT_EPISODES, 30, 5)  # the 1-link cartpole at horizon 30
CAPTURE_TICKS = 5
CAPTURE_SHAPE = (EXPERT_EPISODES, 60, 7)
GOLDEN_SHAPE = (1, 60, 7)  # f64
DAGGER_EPISODES, DAGGER_TICKS, DAGGER_STARTS, DAGGER_EP_LEN = 64, 8, 16, 5
DAGGER_SHAPE = (DAGGER_EPISODES, 5, 16)
CORRECTIVE_SHAPE = (DAGGER_STARTS, 30, 16)
OBSTACLE_EPISODES, OBSTACLE_TICKS, FILTER_TICKS, FILTER_T = 32, 8, 5, 10
PROTOCOL_SHAPES = [(OBSTACLE_EPISODES, 10, 18), (512, 5, 18), (512, 10, 18)]
TEACHER_STARTS = 8  # tick 0 card vs CPU
# the port's IP solve of the golden problem, 12 SQP iterations, f64: its largest
# distance from the committed golden's states, the same as JAX's own IP solve's
# (tests/test_torch_expert_gen.py holds the two solves at 1e-8 on the CPU)
IP_GOLDEN_MAX_DX = 21.317380165


def teacher_phase(c, name, env_name, run, starts, shape):
    """An MPC teacher: tick 0 of TEACHER_STARTS starts card vs CPU in f64
    (ACTION_TOL), then `run(device)` on the card with the counts set to 0
    just before: every solve through the warp kernel at `shape`, its
    first Newton systems held against the plain solve, finite episodes with
    actions inside the box."""
    from deqmpc_tpu_torch.data import expert_gen

    env = c.make_env(env_name)
    u0 = {}
    for dev in ("cuda", "cpu"):
        eps = run(dev, ep_len=1, x0=starts[:TEACHER_STARTS], noise_std=0.0,
                  dtype=torch.float64)
        u0[dev] = torch.as_tensor(episodes_arrays(eps)[1][:, 0])
    gap = action_gap(u0["cuda"], u0["cpu"])
    phase(f"{name}: tick 0 card vs CPU (f64)", gap=gap)
    reset_counts(c.bt)
    t = time.perf_counter()
    with record_systems(c.newton_al, limit=4) as rec:
        eps = run("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = launch_counts(c.bt)
    S, A = episodes_arrays(eps) if eps else (np.zeros((0, 1, env.nx)), np.zeros((0, 1, env.nu)))
    d = expert_gen.final_distances(eps, env, env_name) if eps else np.zeros(0)
    out = {"wall_s": wall, "counts": counts, "episodes_kept": len(eps),
           "ticks": S.shape[1], "final_dist_median": float(np.median(d)) if eps else None,
           "within_0.25": int((d < 0.25).sum()),
           "tick0_gap_f64": gap, "solves": rec.solve_counts()}
    out["systems"] = check_path_systems(c, rec.systems, {((shape[0], shape[1], shape[2]),
                                                           "torch.float32")}, name)
    phase(f"{name} done", **{k: v for k, v in out.items() if k != "systems"})
    check(gap_within(gap, torch.float64), f"{name}: tick-0 actions card vs CPU (f64) {gap}")
    check(len(eps) > 0 and np.isfinite(S).all() and np.isfinite(A).all() and in_box(env, A),
          f"{name}: {len(eps)} episodes, finite {np.isfinite(S).all()}, box {in_box(env, A)}")
    check_warp_only(counts, name)
    return out, counts


def dynamics_residual(c, env, x0, horizon, al_iters, u_trim, dtype=torch.float32):
    """The teacher's first solve on the card from `x0`: max |x_{t+1} - f(x_t, u_t)|
    over the plan, and |x_0 - x0|."""
    from deqmpc_tpu_torch.policies import TrackingMPC

    tr = TrackingMPC(env, horizon, al_iter=al_iters, dtype=dtype, max_newton_steps=8,
                     rho_max=1e8, device="cuda")
    bsz = x0.shape[0]
    x_ref = torch.as_tensor(env.targ_pos, dtype=torch.float32, device="cuda").expand(
        bsz, horizon, env.nx)
    u_ref = torch.full((bsz, horizon, env.nu), u_trim, dtype=torch.float32, device="cuda")
    with torch.inference_mode():
        xs, us, _, _ = tr(x0.float().cuda(), x_ref, u_ref, tr.init_state(bsz), al_iters=al_iters)
        res = (xs[:, 1:] - env.dynamics(xs[:, :-1], us[:, :-1])).abs().amax(dim=(1, 2))
        res0 = (xs[:, 0] - x0.float().cuda()).abs().amax(dim=-1)
    return {"dyn_res_median": float(res.median()), "dyn_res_max": float(res.max()),
            "x0_res_max": float(res0.max())}


def phase_expert_mpc_rexquad(c):
    """`generate_mpc_expert` on RexQuadrotor at DAgger's settings (horizon 30,
    8 AL iterations, noise 0.1), EXPERT_EPISODES x EXPERT_TICKS, f32; the
    first solve's dynamics residual; then the 1-link cartpole's teacher at
    horizon 30, EXPERT_EPISODES x 3."""
    from deqmpc_tpu_torch.data import expert_gen

    env = c.make_env("rexquadrotor")
    starts = env.reset(torch.Generator().manual_seed(0), EXPERT_EPISODES, device="cpu",
                       dtype=torch.float64)
    phase("expert: MPC teacher, rexquadrotor", episodes=EXPERT_EPISODES, ticks=EXPERT_TICKS,
          shape=EXPERT_SHAPE)
    res = dynamics_residual(c, env, starts, 30, 8, env.u_trim)

    def run(dev, ep_len=EXPERT_TICKS, x0=starts, noise_std=0.1, dtype=torch.float32):
        return expert_gen.generate_mpc_expert(env, ep_len=ep_len, horizon=30, al_iters=8,
                                              noise_std=noise_std, env_name="rexquadrotor",
                                              x0=x0, dtype=dtype, device=dev)

    out, counts = teacher_phase(c, "expert_mpc_rexquad", "rexquadrotor", run, starts,
                                EXPERT_SHAPE)
    out["first_solve"] = res
    phase("expert: the first solve's dynamics residual", **res)
    check(np.isfinite(res["dyn_res_max"]), f"first solve: {res}")

    cp = c.make_env("cartpole1link")
    cp_starts = cp.reset(torch.Generator().manual_seed(1), EXPERT_EPISODES, device="cpu",
                         dtype=torch.float64)
    reset_counts(c.bt)
    with record_systems(c.newton_al) as rec:
        eps = expert_gen.generate_mpc_expert(cp, ep_len=3, horizon=30, al_iters=8,
                                             noise_std=0.1, env_name="cartpole1link",
                                             x0=cp_starts, device="cuda")
    cp_counts, shapes = launch_counts(c.bt), rec.shapes
    out["cartpole1link"] = {"counts": cp_counts, "episodes_kept": len(eps),
                            "solve_shapes": sorted(shapes)}
    phase("expert: MPC teacher, cartpole1link done", **out["cartpole1link"])
    check(shapes == {(CARTPOLE_TEACHER_SHAPE, "torch.float32")} and len(eps) > 0
          and in_box(cp, episodes_arrays(eps)[1]), f"cartpole1link teacher: {out['cartpole1link']}")
    check_warp_only(cp_counts, "the cartpole1link teacher")
    counts = {"launches": counts["launches"] + cp_counts["launches"],
              "launches_by_kernel": {k: counts["launches_by_kernel"][k]
                                     + cp_counts["launches_by_kernel"][k] for k in c.bt.KERNELS}}
    return out, counts


def phase_expert_capture_cartpole2l(c):
    """The 2-link capture teacher at its defaults (horizon 60, 10 AL
    iterations, noise 0.3), EXPERT_EPISODES x CAPTURE_TICKS from its own
    starts; its 0.25 filter reported (`within_0.25`), not applied: 5 ticks
    do not capture."""
    from deqmpc_tpu_torch.data import expert_gen

    env = c.make_env("cartpole2link")
    starts = expert_gen.capture_starts(EXPERT_EPISODES, seed=0)
    phase("expert: capture teacher, cartpole2link", episodes=EXPERT_EPISODES,
          ticks=CAPTURE_TICKS, shape=CAPTURE_SHAPE)

    def run(dev, ep_len=CAPTURE_TICKS, x0=starts, noise_std=0.3, dtype=torch.float32):
        return expert_gen.generate_cartpole2l_capture_expert(
            env, ep_len=ep_len, x0=x0, noise_std=noise_std, tol=math.inf, dtype=dtype,
            device=dev)

    out, counts = teacher_phase(c, "expert_capture_cartpole2l", "cartpole2link", run, starts,
                                CAPTURE_SHAPE)
    res = dynamics_residual(c, env, torch.as_tensor(starts[:TEACHER_STARTS]), 60, 10, 0.0)
    out["first_solve"] = res
    phase("expert: the capture teacher's first solve", **res)
    return out, counts


def phase_expert_analytic(c):
    """The pendulum's energy teacher (256 x 200, noise 0.05: JAX's gate, at
    least 70% within 0.3 of upright) and the flying cascade (256 x 240: at
    least one episode kept, every kept one within 0.25); each card vs CPU on
    TEACHER_STARTS starts at noise 0 over 40 ticks. No solve."""
    from deqmpc_tpu_torch.data import expert_gen

    out = {}
    reset_counts(c.bt)
    pend, fly = c.make_env("pendulum"), c.make_env("FlyingCartpole")
    phase("expert: analytic teachers", pendulum=[256, 200], flying=[256, 240])
    t = time.perf_counter()
    S, _ = episodes_arrays(expert_gen.generate_pendulum_energy_expert(
        pend, n_episodes=256, ep_len=200, noise_std=0.05, device="cuda"))
    err = np.abs(np.mod(S[:, -1, 0] - np.pi + np.pi, 2 * np.pi) - np.pi)
    out["pendulum"] = {"wall_s": time.perf_counter() - t, "upright_share": float((err < 0.3).mean())}
    t = time.perf_counter()
    eps = expert_gen.generate_flying_cartpole_expert(fly, n_episodes=256, ep_len=240,
                                                     device="cuda")
    S, A = episodes_arrays(eps) if eps else (np.zeros((0, 1, 14)), np.zeros((0, 1, 4)))
    ang = np.abs(np.mod(S[:, -1, 6] - np.pi + np.pi, 2 * np.pi) - np.pi)
    pos = np.linalg.norm(S[:, -1, :3], axis=-1)
    out["flying"] = {"wall_s": time.perf_counter() - t, "kept": len(eps),
                     "kept_within": bool(((ang < 0.25) & (pos < 0.25)).all())}
    for name, env, fn in (("pendulum", pend, expert_gen.generate_pendulum_energy_expert),
                          ("flying", fly, expert_gen.generate_flying_cartpole_expert)):
        x0 = env.reset(torch.Generator().manual_seed(2), TEACHER_STARTS, device="cpu",
                       dtype=torch.float64)
        kw = dict(ep_len=40, x0=x0, noise_std=0.0)
        if name == "flying":
            kw["success_filter"] = False
        (Sg, Ag), (Sc, Ac) = (episodes_arrays(fn(env, device=d, **kw)) for d in ("cuda", "cpu"))
        out[name]["card_vs_cpu_max"] = float(max(np.abs(Sg - Sc).max(), np.abs(Ag - Ac).max()))
    counts = launch_counts(c.bt)
    phase("expert: analytic teachers done", **out)
    check(out["pendulum"]["upright_share"] >= 0.7, f"pendulum teacher: {out['pendulum']}")
    check(out["flying"]["kept"] > 0 and out["flying"]["kept_within"] and in_box(fly, A),
          f"flying cascade: {out['flying']}")
    check(all(out[k]["card_vs_cpu_max"] <= ANALYTIC_TOL for k in ("pendulum", "flying")),
          f"analytic teachers card vs CPU beyond {ANALYTIC_TOL}: {out}")
    check(counts["launches"] == 0, f"the analytic teachers launched a solve: {counts}")
    return out, counts


# the analytic teachers, card vs CPU in f64 over 40 ticks from the same starts:
# the same elementwise arithmetic, summed in other orders
ANALYTIC_TOL = 1e-8


def phase_golden_traj(c):
    """`solve_al` in f64 on the card at GOLDEN_SHAPE against the committed
    golden, within JAX's test's limits (defect 1e-4, U 2e-3, X 2e-4), all
    warp, its Newton systems against the plain solve; `solve_ip` on the card
    at 2 SQP iterations against the CPU's (1e-8), and at 12 against the
    committed golden: the distance JAX's own IP solve has (IP_GOLDEN_MAX_DX)."""
    from deqmpc_tpu_torch.data import golden_traj as g

    d = np.load(g.GOLDEN_PATH)
    phase("golden: solve_al on the card", shape=GOLDEN_SHAPE)
    reset_counts(c.bt)
    t = time.perf_counter()
    with record_systems(c.newton_al, limit=16) as rec:
        X, U = g.solve_al(device="cuda")
    out = {"al_wall_s": time.perf_counter() - t, "defect_al": g.rollout_defect(X, U),
           "al_max_dU": float(np.abs(U - d["U"]).max()),
           "al_max_dX": float(np.abs(X - d["X"]).max())}
    counts = launch_counts(c.bt)
    out["counts"], out["solves"] = counts, rec.solve_counts()
    out["systems"] = check_path_systems(c, rec.systems, {(GOLDEN_SHAPE, "torch.float64")},
                                        "golden")
    t = time.perf_counter()
    Xi, Ui = g.solve_ip(device="cuda")
    out["ip_wall_s"] = time.perf_counter() - t
    out["ip_max_dX_golden"] = float(np.abs(Xi - d["X"]).max())
    Xg, Ug = g.solve_ip(qp_iter=2, device="cuda")
    Xc, Uc = g.solve_ip(qp_iter=2, device="cpu")
    out["ip2_card_vs_cpu"] = float(max(np.abs(Xg - Xc).max(), np.abs(Ug - Uc).max()))
    phase("golden done", **{k: v for k, v in out.items() if k != "systems"})
    check(out["defect_al"] < 1e-4 and out["al_max_dU"] < 2e-3 and out["al_max_dX"] < 2e-4,
          f"solve_al on the card against the golden: {out}")
    check(abs(out["ip_max_dX_golden"] - IP_GOLDEN_MAX_DX) <= 1e-6 * IP_GOLDEN_MAX_DX,
          f"solve_ip on the card: max|dX| from the golden {out['ip_max_dX_golden']}, "
          f"JAX's {IP_GOLDEN_MAX_DX}")
    check(out["ip2_card_vs_cpu"] <= 1e-8, f"solve_ip(qp_iter=2) card vs CPU: {out}")
    check_warp_only(counts, "the golden AL solve")
    return out, counts


def phase_dagger_rexquad(c):
    """One DAgger round of config #4 from `checkpoints/rexquad_deqmpc`:
    `collect_policy_states` for DAGGER_EPISODES x DAGGER_TICKS (the envelope
    from the committed RexQuadrotor dataset), DAGGER_STARTS starts chosen,
    `corrective_episodes` of DAGGER_EP_LEN ticks at horizon 30, appended to
    a temporary --out that starts from the committed dataset."""
    from deqmpc_tpu_torch.data import dagger, datagen

    env = c.env
    args = types.SimpleNamespace(**{**c.args, "teacher": "mpc", "dagger_horizon": 30,
                                    "al_iters": 8})
    policy = c.build_policy(vars(args), env, "cuda")
    policy.model.load_state_dict(c.state)
    phase("dagger: config #4", collect=[DAGGER_EPISODES, DAGGER_TICKS], starts=DAGGER_STARTS,
          ep_len=DAGGER_EP_LEN)
    reset_counts(c.bt)
    t = time.perf_counter()
    with record_systems(c.newton_al, limit=4) as rec:
        states = dagger.collect_policy_states(args, env, policy, n_episodes=DAGGER_EPISODES,
                                              ep_len=DAGGER_TICKS)
        t_collect = time.perf_counter() - t
        idx = np.random.default_rng(0).choice(len(states), size=min(DAGGER_STARTS, len(states)),
                                              replace=False)
        starts = states[idx]
        eps = dagger.corrective_episodes(args, env, starts, ep_len=DAGGER_EP_LEN,
                                         noise_std=0.1, device="cuda")
    counts = launch_counts(c.bt)
    committed = datagen.load_expert_pickle(datagen.expert_data_path(env.spec_id, "mpc"))
    with tempfile.TemporaryDirectory(prefix="smoke_ckpt_", dir=".") as tmp:
        written = datagen.write_episodes(f"{tmp}/rexquad.pkl", eps, append=True,
                                         spec_id=env.spec_id, teacher="mpc")
        n_file = len(datagen.load_expert_pickle(f"{tmp}/rexquad.pkl"))
    S, A = episodes_arrays(eps) if eps else (np.zeros((0, 1, 12)), np.zeros((0, 1, 4)))
    out = {"collect_s": t_collect, "wall_s": time.perf_counter() - t, "counts": counts,
           "visited_kept": len(states), "starts": len(starts), "episodes": len(eps),
           "written": n_file, "committed": len(committed), "solves": rec.solve_counts()}
    out["systems"] = check_path_systems(
        c, rec.systems, {((DAGGER_EPISODES, 5, 16), "torch.float32"),
                     ((len(starts), 30, 16), "torch.float32")}, "dagger")
    phase("dagger done", **{k: v for k, v in out.items() if k != "systems"})
    check(0 < len(states) <= DAGGER_EPISODES * DAGGER_TICKS // 4 and np.isfinite(states).all(),
          f"dagger collect: {len(states)} states")
    check(len(starts) == min(DAGGER_STARTS, len(states)) and 0 < len(eps) <= len(starts)
          and np.isfinite(S).all() and np.isfinite(A).all() and in_box(env, A)
          and n_file == len(written) == len(committed) + len(eps),
          f"dagger correctives: {out}")
    check_warp_only(counts, "dagger")
    return out, counts


SAC_ITERS, SAC_EPISODES, SAC_EP_LEN = 2500, 64, 200
# one f32 update of the trained networks, card vs CPU, within SAC_RTOL of each
# quantity's size, on a batch of the replay that lies SAC_MARGIN clear of every
# point where the update's gradient jumps (`sac_kink_margins`): a sample whose
# ReLU input sits within rounding of 0 takes that unit's gradient on one device
# and not on the other, and Adam turns the difference into a step of up to lr
# on a weight with a small second moment (on an H100, a batch drawn without
# this moved the actor loss by 9.7e-4 of its size in one run and 2e-7 in the
# next). SAC_MARGIN is ten times the f32 rounding of a width-256 layer's
# inputs relative to their RMS. SAC_POOL transitions are screened, in at most
# SAC_ROUNDS rounds (a replaced sample moves the updated critic, and with it
# the margins of the actor loss's forward). The first tr.batch of the pool,
# unscreened, are compared too, and reported.
SAC_RTOL, SAC_MARGIN, SAC_POOL, SAC_ROUNDS = 1e-5, 1e-5, 2048, 12


def sac_kink_margins(actor, critics, run):
    """Per sample of the batch, the least distance, over every forward that
    `run()` makes through `actor` and `critics`, from a point where the
    gradient jumps: a ReLU's input from 0 (relative to its layer's RMS over
    the batch), the log-std from its clamp's bounds, q1 from q2 (relative to
    the larger, or to 1)."""
    from deqmpc_tpu_torch.training import sac

    margins, hooks = [], []

    def relu_input(_, __, z):
        z = z.detach()
        margins.append((z.abs() / z.pow(2).mean().sqrt().clamp_min(1e-30)).amin(dim=-1))

    def log_std(_, __, z):
        z = z.detach()
        margins.append(torch.minimum((z - sac.LOG_STD_MIN).abs(),
                                     (z - sac.LOG_STD_MAX).abs()).amin(dim=-1))

    def q_pair(_, __, q):
        q1, q2 = (v.detach() for v in q)
        margins.append((q1 - q2).abs() / torch.maximum(q1.abs(), q2.abs()).clamp_min(1.0))

    hooks = [actor.layers[k].register_forward_hook(relu_input) for k in (0, 1)]
    hooks.append(actor.layers[3].register_forward_hook(log_std))
    for critic in critics:
        hooks += [critic.layers[k].register_forward_hook(relu_input) for k in (0, 1, 3, 4)]
        hooks.append(critic.register_forward_hook(q_pair))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return torch.stack(margins).amin(dim=0).cpu()


def phase_sac_pendulum(c):
    """`SACTrainer` at the CLI's defaults (128 lanes, hdim 256, batch 256,
    a 200,000 ring) for SAC_ITERS iterations, past start_steps, then
    `generate_expert` SAC_EPISODES x SAC_EP_LEN: finite losses, the ring's
    exact fill, actions inside the box; one `_update` on a fixed batch card
    vs CPU (f32) within SAC_RTOL, the batch SAC_MARGIN clear of the update's
    kinks. No solve."""
    import copy as copy_

    from deqmpc_tpu_torch.training import sac

    env = c.make_env("pendulum")
    reset_counts(c.bt)
    tr = sac.SACTrainer(env, "pendulum", device="cuda")
    phase("sac: pendulum", iterations=SAC_ITERS, n_envs=tr.n_envs, hdim=tr.hdim)
    st = tr.init(0)
    t = time.perf_counter()
    st, info = tr.run(st, SAC_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    eps = tr.generate_expert(st, n_episodes=SAC_EPISODES, ep_len=SAC_EP_LEN, noise_std=0.2)
    S, A = episodes_arrays(eps)
    fill = min(SAC_ITERS * tr.n_envs, tr.buffer_size)
    out = {"wall_s": wall, "s_per_iter": wall / SAC_ITERS,
           "critic_loss_last": float(info["critic_loss"][-1]),
           "actor_loss_last": float(info["actor_loss"][-1]), "alpha_last": float(info["alpha"][-1]),
           "rew_last_100": float(info["rew"][-100:].mean()), "replay": [st.replay.size, st.replay.ptr],
           "episodes": len(eps)}
    # one update on a fixed batch: the trained networks, card and CPU
    rp = st.replay
    idx = torch.randint(0, rp.size, (SAC_POOL,), generator=torch.Generator().manual_seed(1))
    pool = tuple(buf[idx.to(buf.device)].cpu() for buf in (rp.obs, rp.act, rp.rew, rp.nobs,
                                                            rp.done))
    pool_eps = torch.randn((SAC_POOL, tr.nu), generator=torch.Generator().manual_seed(2))

    def update(dev, rows, margins=False):
        t_ = sac.SACTrainer(env, "pendulum", buffer_size=8, device=dev)
        s_ = t_.state_from(copy_.deepcopy(st.actor).to(dev), copy_.deepcopy(st.critic).to(dev),
                           torch.Generator().manual_seed(0), float(st.log_alpha))
        s_.target.load_state_dict(st.target.state_dict())
        for name in ("opt_actor", "opt_critic", "opt_alpha"):  # Adam's moments as trained
            getattr(s_, name).load_state_dict(copy_.deepcopy(getattr(st, name).state_dict()))

        def go():
            return t_._update(s_, tuple(v[rows].to(dev) for v in pool), pool_eps[rows].to(dev))

        if margins:
            return sac_kink_margins(s_.actor, (s_.critic, s_.target), go)
        s_, inf_ = go()
        return ({k: float(v) for k, v in inf_.items()},
                {m: torch.cat([p.detach().cpu().flatten() for p in getattr(s_, m).parameters()])
                 for m in ("actor", "critic")})

    # the batch: the first tr.batch of the pool clear of the kinks in an update
    # on the whole pool, then its own update's kinks replaced until none is left
    clear = (update("cpu", torch.arange(SAC_POOL), margins=True) >= SAC_MARGIN).tolist()
    spare = [i for i, ok in enumerate(clear) if ok]
    rows, spare = spare[:tr.batch], spare[tr.batch:]
    for rounds in range(1, SAC_ROUNDS + 1):
        margin = update("cpu", torch.tensor(rows), margins=True)
        near = [i for i, m in zip(rows, margin.tolist()) if m < SAC_MARGIN]
        if not near or len(near) > len(spare) or rounds == SAC_ROUNDS:
            break
        rows = [i for i in rows if i not in near] + spare[:len(near)]
        spare = spare[len(near):]
    rows = torch.tensor(rows)

    def gaps(a, b):
        g = {k: abs(a[0][k] - b[0][k]) / max(abs(b[0][k]), 1e-30) for k in b[0]}
        g.update({m: float((a[1][m] - b[1][m]).abs().max() / b[1][m].abs().max())
                  for m in b[1]})
        return g

    cpu = update("cpu", rows)
    out["update_card_vs_cpu"] = gap = gaps(update("cuda", rows), cpu)
    first = torch.arange(tr.batch)
    out["update_card_vs_cpu_unscreened"] = gaps(update("cuda", first), update("cpu", first))
    out["update_unscreened_kink_margin_min"] = float(update("cpu", first, margins=True).min())
    out["update_batch"] = {"rows": len(rows), "clear_in_pool": sum(clear),
                           "screening_rounds": rounds, "kink_margin_min": float(margin.min())}
    counts = launch_counts(c.bt)
    phase("sac: pendulum done", **out)
    check(all(bool(torch.isfinite(info[k]).all()) for k in info), "sac: non-finite losses")
    check(st.replay.size == fill and st.replay.ptr == SAC_ITERS * tr.n_envs % tr.buffer_size
          and st.step == SAC_ITERS, f"sac: the ring {out['replay']}, step {st.step}")
    check(len(eps) == SAC_EPISODES and np.isfinite(S).all() and in_box(env, A),
          f"sac: {len(eps)} expert episodes, box {in_box(env, A)}")
    check(len(rows) == tr.batch and float(margin.min()) >= SAC_MARGIN,
          f"sac: no batch of the replay {SAC_MARGIN} clear of the update's kinks "
          f"{out['update_batch']}")
    check(all(gap[k] <= SAC_RTOL for k in gap), f"sac: one update card vs CPU {gap}")
    check(counts["launches"] == 0, f"sac launched a solve: {counts}")
    return out, counts


def phase_obstacles_protocol(c):
    """`eval_obstacles.main` on FlyingCartpole_obstacles_dense: the constrained
    arm of `flying_obstacles_aware_r5` (`--obstacle_net_input`), OBSTACLE_EPISODES
    x OBSTACLE_TICKS, its solves at (32,5,18) with obstacle rows; the filter
    arm of `flying_deqmpc_nn` at T_f FILTER_T, OBSTACLE_EPISODES x FILTER_TICKS,
    at (32,5,18) and (32,10,18). Each arm all warp, its systems against the
    plain solve."""
    from deqmpc_tpu_torch import eval_obstacles

    base = ["--env", "FlyingCartpole_obstacles_dense", "--episodes", str(OBSTACLE_EPISODES)]
    arms = {"constrained": ["--ckpt_obs", AWARE_CKPT, "--obstacle_net_input", "--arms",
                            "constrained", "--ep_len", str(OBSTACLE_TICKS)],
            "filter": ["--ckpt_obs", AWARE_CKPT, "--ckpt_plain", FLYING_CKPT, "--arms", "filter",
                       "--safety_filter_T", str(FILTER_T), "--ep_len", str(FILTER_TICKS)]}
    shapes = {"constrained": {((OBSTACLE_EPISODES, 5, 18), "torch.float32")},
              "filter": {((OBSTACLE_EPISODES, 5, 18), "torch.float32"),
                         ((OBSTACLE_EPISODES, FILTER_T, 18), "torch.float32")}}
    out, total = {}, {"launches": 0, "launches_by_kernel": dict.fromkeys(c.bt.KERNELS, 0)}
    for arm, argv in arms.items():
        phase(f"obstacles: the {arm} arm", argv=argv)
        reset_counts(c.bt)
        t = time.perf_counter()
        with record_systems(c.newton_al, limit=3) as rec:
            res = eval_obstacles.main(base + argv)
        counts = launch_counts(c.bt)
        r = res["constrained" if arm == "constrained" else "safety_filter"]
        out[arm] = {**r, "wall_s": time.perf_counter() - t, "counts": counts,
                    "solves": rec.solve_counts(),
                    "systems": check_path_systems(c, rec.systems, shapes[arm], arm)}
        phase(f"obstacles: the {arm} arm done", **{k: v for k, v in out[arm].items()
                                                   if k != "systems"})
        check(r["n_episodes"] == OBSTACLE_EPISODES and r["n_nan"] == 0
              and 0 <= r["collision_rate"] <= 1 and np.isfinite(r["final_dist_mean"]),
              f"the {arm} arm: {r}")
        check_warp_only(counts, f"the obstacle protocol's {arm} arm")
        total["launches"] += counts["launches"]
        for k in c.bt.KERNELS:
            total["launches_by_kernel"][k] += counts["launches_by_kernel"][k]
    return out, total


# -- slice 11: data parallelism over processes, the native oracle, #3b trained --

TWO_RANKS = 2
RANK_TIMEOUT_S = 300  # a rank's process-group init and collectives, and its whole run
# JAX's own sharding and multi-host tolerances (`tests/test_sharding.py`,
# `tests/test_multihost.py`), relative: the loss, the gradient norm, and (a
# tensor's largest gap over its largest entry) every gradient
JAX_SHARD_TOL = {"loss": 2e-5, "grad_norm": 2e-4, "grads": 2e-4}
# config #4's f64 step turns on rounding: a 1e-14 move of its observations
# moves its gradients by about 4% of their largest entries and its Newton
# steps by 2 (on an H100), and so does the other kernel arithmetic of a
# half batch (the network's proposal moves by 1.4e-5); on the CPU a change of
# thread count alone moves them by 4.9%. Its two ranks are held to the larger
# of JAX_SHARD_TOL and SPREAD_FACTOR times the one-process step's own largest
# move under SPREAD_MOVES 1e-14 moves, measured in the same run (skipping the
# all-reduce moves them by over 100%); the worker's pendulum step, which does
# not turn on rounding, is held to JAX_SHARD_TOL, and the CPU tests hold the
# four sharding cases at 1e-9 (`tests/test_torch_parallel.py`).
SPREAD_MOVES, SPREAD_FACTOR = 3, 3.0
RANK_CODE = "import sys, chip_smoke; sys.exit(chip_smoke.rank_main(sys.argv[1]))"


def two_rank_step(c, skip_allreduce=False, rel_noise=0.0, noise_seed=0):
    """Config #4's training step under `--dtype double` (the solver in f64 at
    rho_max 1e8, and here the network in f64 too) from its checkpoint, on
    this process's slice of the seeded global batch of TRAIN_BSZ (all of it
    without a process group), its observations moved by `rel_noise`
    relative; with `skip_allreduce` the gradients stay local (the planted
    fault). Returns the loss, the gradient norm, the gradients and new
    parameters (on the CPU) and the path's counts."""
    from deqmpc_tpu_torch.parallel import collectives, make_mesh, replicate_local, shard_batch

    mesh = make_mesh()
    policy = policy_in(c.build_policy, {**c.args, "dtype": "double"}, c.env, "cuda",
                       torch.float64)
    policy.model.load_state_dict(c.state)
    replicate_local(policy.model, mesh)
    opt = c.train.make_optimizer(policy)
    batch_np = c.expert_batch(c.args["env"], c.env, 0, c.args["T"])
    noise = np.random.default_rng(noise_seed).normal(size=batch_np["obs"].shape)
    batch_np["obs"] = batch_np["obs"].astype(np.float64) * (1 + rel_noise * noise)
    batch = c.train.to_device(shard_batch(batch_np, mesh), "cuda", torch.float64)
    good = collectives.average_gradients
    if skip_allreduce:
        collectives.average_gradients = lambda params: None
    torch.cuda.synchronize()
    before = policy_counts(policy)
    reset_counts(c.bt)
    try:
        t = time.perf_counter()
        res = c.train.train_step(policy, opt, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
    finally:
        collectives.average_gradients = good
    named = dict(policy.model.named_parameters())
    return {"bsz": int(batch["obs"].shape[0]), "loss": float(res["loss"]),
            "grad_norm": float(res["grad_norm"]), "step_s": step_s,
            "grads": {k: p.grad.detach().cpu() for k, p in named.items() if p.grad is not None},
            "params": {k: p.detach().cpu() for k, p in named.items()},
            "counts": path_counts(c.bt, policy, before)}


def rank_main(spec_json):
    """One rank of `start_ranks`, in a process of its own: join the group,
    take config #4's step (and with `plant` the step without the
    all-reduce), save the results to the spec's `out`."""
    from deqmpc_tpu_torch.parallel import initialize_multihost

    spec = json.loads(spec_json)
    torch.cuda.set_device(0)
    torch.set_num_threads(LANE_THREADS)
    initialize_multihost(spec["coordinator"], spec["world"], spec["rank"],
                         backend=spec["backend"], timeout_s=RANK_TIMEOUT_S)
    try:
        c = Ctx.make()
        c.bt._load_library()
        out = {"step": two_rank_step(c)}
        if spec["plant"]:
            out["skip_allreduce"] = two_rank_step(c, skip_allreduce=True)
        torch.save(out, spec["out"])
    finally:
        torch.distributed.destroy_process_group()
    return 0


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(tmp, name, world, backend, plant=False, worker=False):
    """`world` processes on cuda:0 over `backend`, started together: ranks of
    `rank_main` (config #4), or with `worker` of `multihost_worker` (its
    pendulum step). Returns [(process, log path, result path)]."""
    here = os.path.dirname(os.path.abspath(__file__))
    coordinator = f"localhost:{free_port()}"
    procs = []
    for r in range(world):
        out = os.path.join(tmp, f"{name}_r{r}.{'json' if worker else 'pt'}")
        if worker:
            cmd = [sys.executable, "-m", "deqmpc_tpu_torch.multihost_worker", "--process_id",
                   str(r), "--num_processes", str(world), "--coordinator", coordinator,
                   "--out", out, "--device", "cuda", "--backend", backend,
                   "--timeout_s", str(RANK_TIMEOUT_S)]
        else:
            spec = {"coordinator": coordinator, "world": world, "rank": r, "backend": backend,
                    "plant": plant, "out": out}
            cmd = [sys.executable, "-c", RANK_CODE, json.dumps(spec)]
        log = os.path.join(tmp, f"{name}_r{r}.log")
        with open(log, "w") as f:
            procs.append((subprocess.Popen(cmd, cwd=here, stdout=f, stderr=subprocess.STDOUT),
                          log, out))
    return procs


def wait_ranks(procs, what):
    """Each process must exit 0 within RANK_TIMEOUT_S; a rank that fails or
    hangs fails the smoke. Returns their results in rank order."""
    for r, (p, log, _) in enumerate(procs):
        try:
            rc = p.wait(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = "a timeout"
        with open(log) as f:
            tail = f.read()[-3000:]
        check(rc == 0, f"{what}: rank {r} ended with {rc}:\n{tail}")
    results = []
    for _, _, out in procs:
        if out.endswith(".json"):
            with open(out) as f:
                results.append(json.load(f))
        else:
            results.append(torch.load(out, weights_only=False))
    return results


def kill_ranks(procs):
    for p, _, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def step_gaps(a, ref):
    """A step's gaps to `ref`: the loss and gradient norm relative, and the
    worst gradient's largest gap over its tensor's largest entry."""
    return {"loss": rel_gap(a["loss"], ref["loss"]),
            "grad_norm": rel_gap(a["grad_norm"], ref["grad_norm"]),
            "grads": max(float((a["grads"][k] - g).abs().max() / g.abs().max().clamp_min(1e-300))
                         for k, g in ref["grads"].items())}


def ranks_equal(steps):
    """Whether the ranks' losses, gradient norms and new parameters are
    equal bit for bit."""
    first = steps[0]
    return all(s["loss"] == first["loss"] and s["grad_norm"] == first["grad_norm"]
               and all(torch.equal(s["params"][k], v) for k, v in first["params"].items())
               for s in steps[1:])


def within(gaps, tol):
    return all(gaps[k] <= lim for k, lim in tol.items() if k in gaps)


def network_batch_invariance(c):
    """The largest gap of the network's proposal (f64, no solve) of the
    batch's first half, computed on its own and inside the whole batch: what
    the ranks' per-sample arithmetic differs by from one process's."""
    policy = policy_in(c.build_policy, {**c.args, "dtype": "double"}, c.env, "cuda",
                       torch.float64)
    policy.model.load_state_dict(c.state)
    obs = c.train.to_device(c.expert_batch(c.args["env"], c.env, 0, c.args["T"]), "cuda",
                            torch.float64)["obs"][:, -1]
    half = obs.shape[0] // TWO_RANKS
    with torch.inference_mode():
        whole = policy.forward(obs, qp_solve=False)["trajs"][-1][0][:half]
        part = policy.forward(obs[:half].clone(), qp_solve=False)["trajs"][-1][0]
    return float((whole - part).abs().max())


def phase_train_rexquad_two_ranks(c):
    """Data parallelism on the card, all rank processes started together:
    (1) `multihost_worker`'s pendulum step over TWO_RANKS processes sharing
    the card over gloo (nccl refuses two ranks on one GPU) against one
    process over nccl: the ranks equal, the loss and gradient norm within
    JAX_SHARD_TOL (as `tests/test_multihost.py` holds JAX); (2) config #4's
    f64 step over TWO_RANKS gloo processes, 64 samples each of the seeded
    batch of TRAIN_BSZ, against the one-process step on all 128: the ranks'
    new parameters equal bit for bit, the loss, gradient norm and every
    gradient within the larger of JAX_SHARD_TOL and SPREAD_FACTOR times the
    one-process step's own move (SPREAD_MOVES 1e-14 moves of its
    observations); the same step with the gradient all-reduce skipped must
    fail that check; one process over nccl (the nccl route starts and
    all-reduces) within JAX_SHARD_TOL of the one-process step. Every solve
    of every step through the warp kernel."""
    phase("train: data parallel", ranks=TWO_RANKS, bsz=TRAIN_BSZ, backend="gloo")
    with tempfile.TemporaryDirectory(prefix="smoke_ranks_", dir=".") as tmp:
        groups = {}
        try:
            groups["worker_two"] = start_ranks(tmp, "worker_two", TWO_RANKS, "gloo",
                                               worker=True)
            groups["worker_one"] = start_ranks(tmp, "worker_one", 1, "nccl", worker=True)
            groups["config4_two"] = start_ranks(tmp, "config4_two", TWO_RANKS, "gloo",
                                                plant=True)
            groups["config4_one"] = start_ranks(tmp, "config4_one", 1, "nccl")
            # the one-process references, while the ranks run
            one = two_rank_step(c)
            moved = [two_rank_step(c, rel_noise=1e-14, noise_seed=s)
                     for s in range(SPREAD_MOVES)]
            invariance = network_batch_invariance(c)
            res = {name: wait_ranks(procs, name) for name, procs in groups.items()}
        finally:
            for procs in groups.values():
                kill_ranks(procs)
    worker, (worker_one,) = res["worker_two"], res["worker_one"]
    steps = [r["step"] for r in res["config4_two"]]
    planted = [r["skip_allreduce"] for r in res["config4_two"]]
    nccl = res["config4_one"][0]["step"]
    spread = {k: max(step_gaps(m, one)[k] for m in moved) for k in JAX_SHARD_TOL}
    tol = {k: max(JAX_SHARD_TOL[k], SPREAD_FACTOR * spread[k]) for k in JAX_SHARD_TOL}
    out = {"worker": {"ranks": worker, "one_process_nccl": worker_one,
                      "gap": {k: rel_gap(worker[0][k], worker_one[k])
                              for k in ("loss", "grad_norm", "new_param_norm")}},
           "one_process": {k: one[k] for k in ("bsz", "loss", "grad_norm", "step_s")},
           "ranks": [{k: s[k] for k in ("bsz", "loss", "grad_norm", "step_s", "counts")}
                     for s in steps],
           "ranks_bitwise_equal": ranks_equal(steps),
           "one_process_spread_1e-14": spread, "tol": tol,
           "gap_two_ranks_vs_one": step_gaps(steps[0], one),
           "planted_skip_allreduce": {"gap": step_gaps(planted[0], one),
                                      "ranks_bitwise_equal": ranks_equal(planted)},
           "nccl_world1": {k: nccl[k] for k in ("bsz", "loss", "grad_norm", "step_s")},
           "gap_nccl_world1_vs_one": step_gaps(nccl, one),
           "network_batch_invariance": invariance,
           "newton_steps": {"one": one["counts"]["newton_steps"],
                            "moved": [m["counts"]["newton_steps"] for m in moved],
                            "ranks": [s["counts"]["newton_steps"] for s in steps]}}
    phase("train: data parallel done", **out)
    check(all(w["process_count"] == TWO_RANKS for w in worker)
          and all(worker[0][k] == w[k] for w in worker
                  for k in ("loss", "grad_norm", "new_param_norm")),
          f"the worker's ranks differ: {worker}")
    check(within(out["worker"]["gap"], JAX_SHARD_TOL),
          f"the worker's two ranks vs one process beyond {JAX_SHARD_TOL}: {out['worker']}")
    check(all(s["bsz"] == TRAIN_BSZ // TWO_RANKS for s in steps),
          f"the ranks' slices: {[s['bsz'] for s in steps]}")
    check(out["ranks_bitwise_equal"], "config #4's two ranks differ")
    check(within(out["gap_two_ranks_vs_one"], tol),
          f"config #4's two ranks vs one process beyond {tol}: {out['gap_two_ranks_vs_one']}")
    bad = out["planted_skip_allreduce"]
    check(not (bad["ranks_bitwise_equal"] and within(bad["gap"], tol)),
          f"the check passed a step without the gradient all-reduce: {bad}")
    check(within(out["gap_nccl_world1_vs_one"], JAX_SHARD_TOL),
          f"the nccl step vs one process beyond {JAX_SHARD_TOL}: {out['gap_nccl_world1_vs_one']}")
    for i, s in enumerate(steps + [nccl, one] + moved):
        check_all_warp(s["counts"], f"the data-parallel phase's step {i}")
        check(s["counts"]["backward_solves"] == c.args["deq_iter"],
              f"the data-parallel phase's step {i}: {s['counts']}")
    return out, one["counts"]


NATIVE_STATES = 1024
# `tests/test_native.py`'s tolerances
NATIVE_TOL = {"dynamics": dict(rtol=1e-9, atol=1e-10), "jacobians": dict(rtol=1e-8, atol=1e-9)}
NATIVE_ENVS = (("pendulum1l", "pendulum"), ("cartpole1l", "cartpole1link"),
               ("cartpole2l", "cartpole2link"))


def phase_native_oracle(c):
    """The card's f64 `dynamics` and `dynamics_derivatives` (the vmap(jacfwd)
    Jacobians) of the pendulum and the 1- and 2-link cartpoles at
    NATIVE_STATES seeded states, against the native C++ oracle on the host
    (`envs/native_bridge.py`, compiled from `native/src/dynamics.cpp` here),
    within NATIVE_TOL. No block-tridiagonal solve."""
    from deqmpc_tpu_torch.envs import native_bridge

    phase("native oracle", states=NATIVE_STATES)
    reset_counts(c.bt)
    t = time.perf_counter()
    native_bridge.build_native()
    out = {"build_s": time.perf_counter() - t, "cases": {}}
    for package, name in NATIVE_ENVS:
        env = c.make_env(name)
        nat = native_bridge.NativeDynamics(package, env.dt)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(NATIVE_STATES, env.nx)) * 0.5
        u = rng.normal(size=(NATIVE_STATES, env.nu)) * 0.5
        xt, ut = (torch.as_tensor(a, dtype=torch.float64, device="cuda") for a in (x, u))
        t = time.perf_counter()
        with torch.no_grad():
            x_next = env.dynamics(xt, ut)
            _, (Jx, Ju) = env.dynamics_derivatives(xt, ut)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        ref_next = nat.dynamics(x, u)
        _, (Jx_n, Ju_n) = nat.dynamics_derivatives(x, u)
        host_s = time.perf_counter() - t
        got = {"dynamics": [(x_next, ref_next)], "jacobians": [(Jx, Jx_n), (Ju, Ju_n)]}
        case = {"card_s": card_s, "host_s": host_s}
        for kind, pairs in got.items():
            case[f"{kind}_max_abs_gap"] = max(float(np.max(np.abs(a.cpu().numpy() - b)))
                                              for a, b in pairs)
            for a, b in pairs:
                np.testing.assert_allclose(a.cpu().numpy(), b, **NATIVE_TOL[kind],
                                           err_msg=f"{name} {kind}, card vs native")
        out["cases"][name] = case
    phase("native oracle done", **out)
    counts = launch_counts(c.bt)
    check(counts["launches"] == 0, f"the native oracle phase launched solves: {counts}")
    return out, counts


OBSTACLE_TRAIN_EPISODES, OBSTACLE_TRAIN_TICKS = 64, 240
OBSTACLE_TRAIN_MIN_KEPT = 8


def phase_train_flying_obstacles(c):
    """Config #3b trained from `checkpoints/flying_obstacles` (40 spheres, the
    4 nearest per knot as rows, in the forward and the implicit backward),
    as config #3 (`train_config`, `check_train`), on data the port's
    obstacle-filtered cascade teacher generates on the card
    (OBSTACLE_TRAIN_EPISODES x OBSTACLE_TRAIN_TICKS, the finished episodes
    that never enter a sphere kept), written to a temporary directory and
    read back through `split_episodes`, `sample_trajectory` and
    `preprocess_batch`; the share of the batch's samples with an active
    obstacle row (one card forward) and the backward's zeroed share
    printed. Its f64 step 0 turns on rounding, so the card's own spread
    under SPREAD_MOVES 1e-14 moves is measured and the f64 check takes the
    larger of STEP0_RTOL and SPREAD_FACTOR times it."""
    from deqmpc_tpu_torch.data import datagen, expert_gen

    state, args = c.load_checkpoint(FLYING_OBS_CKPT, "cuda")
    env = c.make_env_of(args)
    obstacles = c.build_obstacles(env)
    phase("train: config #3b", episodes=OBSTACLE_TRAIN_EPISODES, ticks=OBSTACLE_TRAIN_TICKS,
          bsz=TRAIN_BSZ, steps=TRAIN_STEPS, spheres=len(env.obstacle_positions))
    t = time.perf_counter()
    episodes = expert_gen.generate_flying_cartpole_expert(
        env, n_episodes=OBSTACLE_TRAIN_EPISODES, ep_len=OBSTACLE_TRAIN_TICKS, seed=0,
        device="cuda")
    gen_s = time.perf_counter() - t
    check(len(episodes) >= OBSTACLE_TRAIN_MIN_KEPT,
          f"the cascade kept {len(episodes)} of {OBSTACLE_TRAIN_EPISODES} episodes")
    pos = np.concatenate([np.stack([s for s, _ in ep])[:, :3] for ep in episodes])
    clear = np.linalg.norm(pos[:, None] - env.obstacle_positions[None], axis=-1).min()
    check(clear > env.obstacle_radius, f"a kept episode enters a sphere: {clear}")
    with tempfile.TemporaryDirectory(prefix="smoke_data_", dir=".") as tmp:
        path = os.path.join(tmp, "expert_traj.pkl")
        datagen.write_episodes(path, episodes)
        gt, _ = c.train.split_episodes(datagen.load_expert_pickle(path))
    batch_np = c.train.preprocess_batch(args["env"], env.nx, c.data.sample_trajectory(
        gt, TRAIN_BSZ, 1, args["T"], np.random.default_rng(3)))
    policy = policy_in(c.build_policy, args, env, "cuda", torch.float32, obstacles=obstacles)
    policy.model.load_state_dict(state)
    rows = record_obstacle_rows(policy, c.obstacle_residuals)
    with torch.inference_mode():
        policy.forward(c.train.to_device(batch_np, "cuda")["obs"][:, -1])
    tr = train_config(c.bt, c.train, c.build_policy, c.newton_al, state, args, env, batch_np,
                      sensitivity=False, obstacles=obstacles, moves=SPREAD_MOVES)
    tr["data"] = {"kept": len(episodes), "of": OBSTACLE_TRAIN_EPISODES, "gen_s": gen_s,
                  "train_states": int(len(gt["state"])), "clearance_min": float(clear)}
    tr["obstacle_rows_active_share"] = active_share(rows)
    tr["ncon"] = policy.tracking_mpc.ctrl.ncon
    for s_ in tr["steps"]:
        print(f"[chip_smoke]   step {json.dumps(s_)}", flush=True)
    phase("train: config #3b done", **{k: v for k, v in tr.items() if k != "steps"})
    check(tr["ncon"] > env.nx * args["T"] + 2 * env.nu * args["T"],
          f"config #3b's solver has no obstacle rows: ncon {tr['ncon']}")
    # its f64 loss turns on rounding: a 1e-14 move of the observations moves
    # it by 0.74-0.99% on the CPU (four moves), the card's gap to the CPU
    # 0.35% (an H100): held by the card's own spread
    check_train(tr, "config-#3b training", spread_factor=SPREAD_FACTOR)
    return tr, tr["counts"]


PHASES = {"serve_rexquad": phase_serve_rexquad, "train_rexquad": phase_train_rexquad,
          "train_pendulum": phase_train_pendulum, "serve_pendulum": phase_serve_pendulum,
          "serve_streaming": phase_serve_streaming, "train_streaming": phase_train_streaming,
          "serve_cartpole": phase_serve_new(CARTPOLE_CKPT),
          "serve_flying": phase_serve_new(FLYING_CKPT),
          "serve_flying_obstacles": phase_serve_new(FLYING_OBS_CKPT),
          "train_cartpole": phase_train_new(CARTPOLE_CKPT, "sac"),
          "train_flying": phase_train_new(FLYING_CKPT, "mpc"),
          "serve_pendulum_diffmpc": phase_serve_new(PENDULUM_DIFF_CKPT),
          "serve_flying_diffmpc": phase_serve_new(FLYING_DIFF_CKPT),
          "train_diffmpc": phase_train_new(FLYING_DIFF_CKPT, "mpc"),
          "serve_ip": phase_serve_new(PENDULUM_CKPT, {"solver_type": "ip"}),
          "train_ip": phase_train_ip,
          "serve_flying_aware": phase_serve_new(AWARE_CKPT),
          **{f"train_variants_{n}": phase_train_variant(n) for n in VARIANT_FLAGS},
          **{f"serve_variants_{n}": phase_serve_variant(n) for n in SERVED_VARIANTS},
          "train_rexquad_implicit": phase_train_rexquad_with(
              "implicit", {"grad_type": "implicit"},
              [("implicit_one_step_adjoint", plant_one_step_adjoint)], planted=True, backward=6),
          # under the refresh the last AL iteration's Newton call tracks a
          # detached cost: no implicit backward runs, so no sign flip to plant
          "train_rexquad_recompute": phase_train_rexquad_with(
              "recompute_Qq", {"recompute_Qq": True},
              [("refresh_dropped", plant_refresh_dropped)], planted=False, backward=0),
          "serve_rexquad_recompute": phase_serve_new(CKPT, {"recompute_Qq": True}, ticks=TICKS),
          "serve_rexquad_bf16": phase_serve_new(CKPT, {"compute_dtype": "bf16"}, ticks=TICKS),
          **{f"train_slice8_{n}": phase_train_slice8(n) for n in SLICE8_FLAGS},
          "train_flying_qscale": phase_train_new(FLYING_CKPT, "mpc", {"Qscale": 2.0}),
          "train_rexquad_double": phase_train_rexquad_double,
          "train_pendulum_cli": phase_train_pendulum_cli,
          "profile_step": phase_profile_step,
          "eval_x_window": phase_eval_x_window,
          "expert_mpc_rexquad": phase_expert_mpc_rexquad,
          "expert_capture_cartpole2l": phase_expert_capture_cartpole2l,
          "expert_analytic": phase_expert_analytic, "golden_traj": phase_golden_traj,
          "dagger_rexquad": phase_dagger_rexquad, "sac_pendulum": phase_sac_pendulum,
          "obstacles_protocol": phase_obstacles_protocol,
          "train_rexquad_two_ranks": phase_train_rexquad_two_ranks,
          "native_oracle": phase_native_oracle,
          "train_flying_obstacles": phase_train_flying_obstacles}
# The phases run in LANES worker processes at once, each lane's in turn: a
# phase keeps the card idle over 95% of its time (its host dispatches the
# ops one by one), so three host threads share the card with little
# interference; the kernel timings and bench_streaming run alone. Lanes are
# balanced on the phases' times when they ran in one process (PERF.md); the
# last two (the policy variants and the aware checkpoint) took 280 s and
# 250 s running side by side. Slice 10's phases lead the lanes, the longest
# (the capture teacher, 140 s in a lane of its own) in the lane that ended first;
# slice 11's close the three lanes that ended first in the last whole runs.
LANES = (("dagger_rexquad", "serve_flying_obstacles", "train_streaming",
          "train_rexquad_implicit"),
         ("expert_capture_cartpole2l", "serve_flying", "serve_streaming", "train_rexquad",
          "train_rexquad_recompute", "train_slice8_multi_bptt"),
         ("expert_mpc_rexquad", "serve_cartpole", "train_flying", "train_cartpole", "serve_rexquad",
          "train_pendulum", "serve_pendulum", "serve_rexquad_recompute", "eval_x_window",
          "train_rexquad_two_ranks"),
         ("obstacles_protocol", "serve_flying_diffmpc", "train_diffmpc", "serve_pendulum_diffmpc",
          "train_ip", "serve_ip", "serve_rexquad_bf16", "train_flying_qscale",
          "train_flying_obstacles"),
         ("sac_pendulum", "serve_flying_aware", "train_variants_mem", "train_variants_delta",
          "train_variants_q", "serve_variants_mem", "serve_variants_delta", "train_slice8_broyden",
          "train_slice8_broyden_implicit", "train_slice8_bf16", "train_pendulum_cli",
          "profile_step", "native_oracle"),
         ("golden_traj", "expert_analytic", "train_variants_history", "train_variants_estpred",
          "train_variants_feedback", "train_variants_history_joint", "serve_variants_feedback",
          "serve_variants_q", "train_slice8_multi_last_step", "train_slice8_grad_coeff",
          "train_rexquad_double"))
LANE_THREADS = 2  # torch's CPU threads per lane (the CPU references)


def run_lane(names, t0, trace_lock):
    """A worker process: run the named phases in turn on the card, its
    clock started at the parent's `t0`, tracing in turn with the other
    lanes (`trace_lock`). Returns {phase: (its report, the path's launch
    counts)}; a failed check raises into the parent."""
    global T0, TRACE_LOCK
    T0, TRACE_LOCK = t0, trace_lock
    torch.set_num_threads(LANE_THREADS)
    c = Ctx.make()
    c.bt._load_library()
    return {name: PHASES[name](c) for name in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run after the kernel checks (default: all)")
    selected = ap.parse_args(argv).phases
    selected = None if selected is None else selected.split(",")
    if selected is not None and not set(selected) <= set(PHASES) | {"bench_streaming"}:
        print(f"chip_smoke: unknown phases {sorted(set(selected) - set(PHASES))}",
              file=sys.stderr)
        return 2
    # -- 1. device ----------------------------------------------------------
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 1
    c = Ctx.make()
    bt, tridiag = c.bt, c.tridiag
    smi = c.card_info()["nvidia_smi"]
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
            # sample 1 is not SPD; a batch of one is checked SPD, then not SPD
            for bad in ([1] if bsz > 1 else [None, 0]):
                D, O, b = problem(bsz, T, n, dtype, nonspd=bad)
                x_ref = tridiag.block_tridiag_solve(D, O, b)
                keep = torch.ones(bsz, dtype=torch.bool, device="cuda")
                if bad is not None:
                    check(bool(torch.isnan(x_ref[bad]).all()),
                          f"plain: non-SPD sample not NaN at {(bsz, T, n)}")
                    keep[bad] = False
                for kernel in dict.fromkeys([bt.pick_kernel(n), "block"]):
                    x = bt.block_tridiag_solve(D, O, b, kernel=kernel)
                    torch.cuda.synchronize()
                    where = f"{kernel} kernel at {(bsz, T, n)} {dtype}"
                    if bad is not None:
                        check(bool(torch.isnan(x[bad]).all()), f"non-SPD sample not NaN: {where}")
                    if not bool(keep.any()):
                        continue
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

    # -- 4-10, 12-44. the paths, in LANES worker processes ------------------------
    lanes = [[n for n in lane if selected is None or n in selected] for lane in LANES]
    lanes = [lane for lane in lanes if lane]
    phase("paths", lanes=lanes)
    results, failures = {}, []
    if lanes:
        ctx = multiprocessing.get_context("spawn")
        with tempfile.TemporaryDirectory(prefix="smoke_lock_", dir=".") as tmp, \
                concurrent.futures.ProcessPoolExecutor(len(lanes), mp_context=ctx) as pool:
            lock = os.path.join(tmp, "trace.lock")
            for fut in [pool.submit(run_lane, lane, T0, lock) for lane in lanes]:
                try:
                    results.update(fut.result())
                except Exception as e:  # every lane runs to its end; the first failure raises
                    print(f"[chip_smoke] a lane failed: {e}", flush=True)
                    failures.append(e)
    report.update({name: data for name, (data, _) in results.items()})
    if failures:
        raise failures[0]
    paths = {name: counts for name, (_, counts) in results.items()}

    # -- 11. bench_streaming, alone on the card ------------------------------------
    if selected is None or "bench_streaming" in selected:
        phase("bench_streaming", fleet_bsz=BENCH_FLEET, n_rep=BENCH_REPS)
        bench = c.bench_streaming.main(["--fleet_bsz", str(BENCH_FLEET), "--n_rep",
                                        str(BENCH_REPS), "--n_warmup", "1"])
        report["bench_streaming"] = bench
        check(all(np.isfinite(bench[k][f]) for k in ("single", "fleet")
                  for f in ("cold_ms", "warm_ms_per_tick")), f"bench_streaming: {bench}")

    if selected is not None:  # a debugging run: no kernels line, no ok line
        report["wall_s"] = time.perf_counter() - T0
        print(f"[chip_smoke] report {json.dumps(report)}", flush=True)
        phase("done", phases=selected)
        return 0

    # -- result ------------------------------------------------------------------
    main_t = timings[0]
    kernels = [{
        "name": f"block_tridiag_solve[{kernel}]", "route": "cuda",
        "source": "deqmpc_tpu_torch/ops/csrc/block_tridiag.cu",
        "replaces": "deqmpc_tpu/ops/pallas_tridiag.py:100",
        "launches": paths["train_streaming"]["launches_by_kernel"][kernel],
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
