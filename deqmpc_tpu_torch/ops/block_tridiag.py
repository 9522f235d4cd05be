"""Batched block-tridiagonal SPD solve: the wrapper of the Hopper kernels.

`block_tridiag_solve(D, O, b)` replaces `pallas_block_tridiag_solve`
(`deqmpc_tpu/ops/pallas_tridiag.py:167-199`). On CUDA tensors it
launches a kernel in `csrc/block_tridiag.cu`, or raises; on CPU tensors
it runs the plain version in `ops/tridiag.py`. Nothing falls back from
one to the other.

The source holds two kernels of the same function. For n <= 32 (every
env) the wrapper launches the warp kernel (one warp per sample); for
n > 32 the block kernel (one thread block per sample). `kernel="block"`
launches the block kernel at any n, to time the two side by side.

The kernels are built at first use with `nvcc` into `ops/_build/<hash>/`
(the hash covers the source and the flags) as one shared library with a
plain C interface, and loaded with ctypes: no PyTorch headers, so the
build takes seconds. `block_tridiag_solve.launches` counts every launch,
and `block_tridiag_solve.launches_by_kernel` counts them per kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils import profiling
from . import tridiag

SOURCE = Path(__file__).resolve().parent / "csrc" / "block_tridiag.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -split-compile=0 runs the optimiser over the kernel instantiations on
# every core (one nvcc call; the fully unrolled warp kernels take most of it)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "block_tridiag: nvcc not found (looked in $CUDA_HOME/bin and PATH); "
            "the CUDA kernel cannot be built")
    return found


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / key / "libblock_tridiag.so"


def build() -> str:
    """Compiles the kernel unless this source was built already. Returns
    nvcc's report (registers, shared memory, spills), or "" if cached."""
    out = library_path()
    if out.is_file():
        return ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    profiling.count("kernel_builds")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"block_tridiag: nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return res.stdout + res.stderr


WARP_MAX_N = 32  # the warp kernel's largest block: one lane per row
KERNELS = ("warp", "block")
# each kernel's function name, as the profiler's key shows it
KERNEL_FUNCTIONS = {"warp": "bt_warp_kernel", "block": "block_tridiag_solve_kernel"}
MAX_WARPS = 4  # samples per CTA of the warp kernel


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    with profiling.span("b1.load"):
        build()
        lib = ctypes.CDLL(str(library_path()))
        ptrs = [ctypes.c_void_p] * 5
        for fn in (lib.bt_warp_solve_f32, lib.bt_warp_solve_f64):
            fn.argtypes = ptrs + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.bt_block_solve_f32, lib.bt_block_solve_f64):
            fn.argtypes = ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.bt_warp_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.bt_warp_smem_bytes.restype = ctypes.c_size_t
        lib.bt_warp_scratch_elems.argtypes = [ctypes.c_int] * 2
        lib.bt_warp_scratch_elems.restype = ctypes.c_size_t
        lib.bt_block_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.bt_block_smem_bytes.restype = ctypes.c_size_t
        lib.bt_smem_optin.argtypes = [ctypes.c_int]
        lib.bt_smem_optin.restype = ctypes.c_int
        lib.solve = {("warp", torch.float32): lib.bt_warp_solve_f32,
                     ("warp", torch.float64): lib.bt_warp_solve_f64,
                     ("block", torch.float32): lib.bt_block_solve_f32,
                     ("block", torch.float64): lib.bt_block_solve_f64}
        return lib


@functools.lru_cache(maxsize=None)
def _smem_optin(lib: ctypes.CDLL, device_index: int) -> int:
    v = lib.bt_smem_optin(device_index)
    if v < 0:
        raise RuntimeError(f"block_tridiag: cudaDeviceGetAttribute failed (CUDA error {-v})")
    return v


@functools.lru_cache(maxsize=None)
def _plan(lib: ctypes.CDLL, kernel: str, T: int, n: int, elem: int, optin: int):
    """(warps per CTA, all kept blocks in shared memory) for one launch:
    the warp kernel takes the most samples per CTA whose kept blocks all
    fit, else keeps them in device scratch; the block kernel has one
    sample per CTA."""
    if kernel == "block":
        return 1, lib.bt_block_smem_bytes(T, n, elem, 1) <= optin
    for warps in (MAX_WARPS, 2, 1):
        if lib.bt_warp_smem_bytes(T, n, elem, 1, warps) <= optin:
            return warps, True
    return MAX_WARPS, False


def pick_kernel(n: int, kernel: str | None = None) -> str:
    """The kernel that solves blocks of size n: the warp kernel up to
    WARP_MAX_N, else the block kernel; `kernel` names one explicitly."""
    if kernel is None:
        return "warp" if n <= WARP_MAX_N else "block"
    if kernel not in KERNELS:
        raise ValueError(f"block_tridiag: unknown kernel {kernel!r}, expected one of {KERNELS}")
    if kernel == "warp" and n > WARP_MAX_N:
        raise ValueError(f"block_tridiag: the warp kernel takes n <= {WARP_MAX_N}, got n = {n}")
    return kernel


def _check_args(D, O, b):
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"D must be (bsz, T, n, n), got {tuple(D.shape)}")
    bsz, T, n, _ = D.shape
    if tuple(O.shape) != (bsz, max(T - 1, 0), n, n):
        raise ValueError(f"O must be {(bsz, max(T - 1, 0), n, n)}, got {tuple(O.shape)}")
    if tuple(b.shape) != (bsz, T, n):
        raise ValueError(f"b must be {(bsz, T, n)}, got {tuple(b.shape)}")
    if not (D.dtype == O.dtype == b.dtype) or D.dtype not in (torch.float32, torch.float64):
        raise TypeError("D, O, b must share float32 or float64, got "
                        f"{D.dtype}, {O.dtype}, {b.dtype}")
    if not (D.device == O.device == b.device):
        raise ValueError(f"D, O, b must be on one device, got {D.device}, {O.device}, {b.device}")


def _solve_cuda(D, O, b, kernel=None):
    """The CUDA branch: launch a kernel or raise."""
    lib = _load_library()
    if not (D.is_contiguous() and O.is_contiguous() and b.is_contiguous()):
        raise ValueError("block_tridiag: D, O and b must be contiguous")
    bsz, T, n, _ = D.shape
    name = pick_kernel(n, kernel)
    x = torch.empty_like(b)
    if bsz == 0:
        return x
    warps, all_in_smem = _plan(lib, name, T, n, D.element_size(),
                               _smem_optin(lib, D.device.index))
    scratch = None
    if not all_in_smem:
        per_sample = (lib.bt_warp_scratch_elems(T, n) if name == "warp" else 2 * T * n * n)
        scratch = torch.empty((bsz, per_sample), dtype=D.dtype, device=D.device)
    args = [D.data_ptr(), O.data_ptr(), b.data_ptr(), x.data_ptr(),
            None if scratch is None else scratch.data_ptr(), bsz, T, n, int(all_in_smem)]
    if name == "warp":
        args.append(warps)
    err = lib.solve[name, D.dtype](*args, torch.cuda.current_stream(D.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_tridiag: {name} kernel launch failed with CUDA error {err}")
    block_tridiag_solve.launches += 1
    block_tridiag_solve.launches_by_kernel[name] += 1
    return x


def block_tridiag_solve(D, O, b, kernel=None):
    """Solve H x = b for a batch of SPD block-tridiagonal H.

    D (bsz, T, n, n), O (bsz, T-1, n, n), b (bsz, T, n) -> x (bsz, T, n),
    float32 or float64. A block that is not positive definite gives NaN
    for its sample. On CUDA tensors `kernel` ("warp" or "block") picks a
    kernel instead of `pick_kernel`'s choice; CPU tensors have no kernel."""
    _check_args(D, O, b)
    if D.device.type == "cpu":
        if kernel is not None:
            raise ValueError("block_tridiag: kernel= needs CUDA tensors; "
                             "the CPU runs the plain version")
        return tridiag.block_tridiag_solve(D, O, b)
    if D.device.type != "cuda":
        raise ValueError(f"block_tridiag: unsupported device {D.device}")
    if D.device.index == torch.cuda.current_device():
        return _solve_cuda(D, O, b, kernel)
    with torch.cuda.device(D.device):
        return _solve_cuda(D, O, b, kernel)


block_tridiag_solve.launches = 0
block_tridiag_solve.launches_by_kernel = dict.fromkeys(KERNELS, 0)
