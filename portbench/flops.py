"""The work a tick or a step needs, counted from shapes and the Newton
counters, the same whatever implements it; and the B1 solve's bound.

The operation counts are of the algorithm, not of the port's kernels:

  * the network: one round of the policy (input encoder, the fixed point's
    cell applications, the head) counted operation by operation on the frozen
    reference (`ref/`) at a batch of two, per sample, times the rounds;
  * the dynamics: one RK4 step counted likewise on the reference's env; its
    Jacobian by forward mode costs one primal and one tangent per input
    direction, (1 + nx + nu) dynamics;
  * a Newton step at each of the T knots: the Jacobian, the assembly of the
    Hessian blocks and the gradient, the block-tridiagonal factor and solve
    (once more for a retry), the line search's `N_LS` merit evaluations and
    the residual norm;
  * an AL iteration: one merit, one residual norm and the dual update.

Every count is of multiply-adds as 2 operations and of an elementwise or
reducing operation as 1 per element it writes or reads.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet
PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores (the port runs with TF32 off)
N_LS = 20                  # the line search's step sizes (`NewtonALConfig.n_ls`)

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm"}
_FREE = {"view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t", "select",
         "slice", "unsqueeze", "squeeze", "detach", "alias", "clone", "copy_", "_to_copy",
         "empty", "empty_like", "zeros", "zeros_like", "ones", "ones_like", "full",
         "full_like", "new_zeros", "new_ones", "new_empty", "new_full", "fill_", "zero_",
         "cat", "stack", "index", "index_select", "gather", "split", "split_with_sizes",
         "unbind", "lift_fresh", "arange", "as_strided", "contiguous", "eye", "lt", "le",
         "gt", "ge", "eq", "ne", "logical_and", "logical_or", "logical_not", "isfinite",
         "isnan", "where", "_local_scalar_dense", "scalar_tensor", "flip", "roll",
         "constant_pad_nd", "repeat", "masked_fill", "argmin", "argmax", "topk", "sort",
         "_reshape_alias", "set_", "resize_", "item", "select_scatter", "slice_scatter",
         "index_put_", "index_put", "diagonal", "diag_embed", "tril", "triu"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "norm", "linalg_vector_norm", "prod",
           "var", "var_mean", "std", "logsumexp", "cumsum", "cumprod", "native_group_norm",
           "native_layer_norm", "softmax", "_softmax", "log_softmax", "_log_softmax"}


class OpCounter(TorchDispatchMode):
    """Counts the operations of what runs under it: matrix products and
    convolutions by their multiply-adds, reductions by the elements read,
    every other arithmetic operation by the elements written; views, copies
    and comparisons are free."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.rstrip("_") or func.overloadpacket.__name__
        if name in _MATMUL:
            a, b = (args[1], args[2]) if name.startswith(("add", "badd")) else (args[0], args[1])
            self.flops += 2 * a.numel() * b.shape[-1]
        elif name == "convolution":
            self.flops += 2 * out.numel() * args[1][0].numel()
        elif name in _REDUCE:
            self.flops += args[0].numel()
        elif name not in _FREE and isinstance(out, torch.Tensor) and out.is_floating_point():
            self.flops += out.numel()
        return out


def count(fn: Callable[[], object]) -> int:
    """The operations `fn()` performs."""
    with OpCounter() as c:
        fn()
    return c.flops


def b1_bound_s(bsz: int, T: int, n: int, elem_bytes: int) -> float:
    """Least time of one block-tridiagonal solve on an H100: each input read
    once (D's lower triangle only: the kernel reads no more) and x written
    once at the HBM rate, or the factor-and-sweep operations at the f32 peak,
    whichever is larger (as `chip_smoke.bound_ms`, in seconds)."""
    nbytes = elem_bytes * bsz * (T * n * (n + 1) // 2 + (T - 1) * n * n + 2 * T * n)
    return max(nbytes / HBM_BYTES_PER_S, b1_flops(bsz, T, n) / PEAK_F32_FLOPS)


def b1_flops(bsz: int, T: int, n: int) -> float:
    """Per sample: T Cholesky factors (n^3/3), T-1 triangular solves with n
    right-hand sides and T-1 products M M' (n^3 each), two sweeps (3n^2 a
    knot each)."""
    return bsz * (T * n**3 / 3 + (T - 1) * 2 * n**3 + T * 6 * n**2)


def newton_step_flops(T: int, nx: int, nu: int, f_dyn: float) -> float:
    """One Newton step of one sample, without the retry's second solve."""
    n = nx + nu
    jac = (T - 1) * (1 + n) * f_dyn
    assemble = T * (2 * nx * n * n + 4 * nx * n + 2 * n * n)
    line_search = N_LS * merit_flops(T, nx, nu, f_dyn)
    return jac + assemble + b1_flops(1, T, n) + line_search + res_norm_flops(T, nx, f_dyn)


def merit_flops(T: int, nx: int, nu: int, f_dyn: float) -> float:
    """The AL merit of one trajectory: the dynamics at T-1 knots, the
    quadratic cost and the multiplier and penalty terms of every row."""
    n = nx + nu
    return (T - 1) * f_dyn + T * (4 * n + 6 * (nx + 2 * nu))


def res_norm_flops(T: int, nx: int, f_dyn: float) -> float:
    return (T - 1) * f_dyn + 2 * T * nx


def al_iteration_flops(T: int, nx: int, nu: int, f_dyn: float) -> float:
    """An AL iteration's own work beside its Newton steps: one merit, one
    residual norm and the dual update."""
    return merit_flops(T, nx, nu, f_dyn) + res_norm_flops(T, nx, f_dyn) + T * 4 * (nx + 2 * nu)


def tick_flops(lanes: int, rounds: int, net_round: float, T: int, nx: int, nu: int,
               f_dyn: float, newton_steps: float, retries: float, al_iters: float) -> float:
    """A closed-loop tick of `lanes` lanes: the network's rounds, the solver's
    Newton steps (`newton_steps` and `retries` per tick, from the policy's
    counters), its AL iterations, and the env's step."""
    n = nx + nu
    per_lane = (rounds * net_round + newton_steps * newton_step_flops(T, nx, nu, f_dyn)
                + retries * b1_flops(1, T, n) + al_iters * al_iteration_flops(T, nx, nu, f_dyn)
                + f_dyn)
    return lanes * per_lane


def per_sample(fn: Callable[[int], object], bsz: int = 2) -> float:
    """The operations of `fn(bsz)` per sample."""
    return count(lambda: fn(bsz)) / bsz

