"""Batched block-tridiagonal SPD solve: the wrapper of the Hopper kernel.

`block_tridiag_solve(D, O, b)` replaces `pallas_block_tridiag_solve`
(`deqmpc_tpu/ops/pallas_tridiag.py:167-199`). On CUDA tensors it
launches the kernel in `csrc/block_tridiag.cu`, or raises; on CPU
tensors it runs the plain version in `ops/tridiag.py`. Nothing falls
back from one to the other.

The kernel is built at first use with `nvcc` into `ops/_build/<hash>/`
(the hash covers the source and the flags) as a shared library with a
plain C interface, and loaded with ctypes: no PyTorch headers, so the
build takes seconds. `block_tridiag_solve.launches` counts the kernel's
launches.
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

from . import tridiag

SOURCE = Path(__file__).resolve().parent / "csrc" / "block_tridiag.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"block_tridiag: nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(library_path()))
    ptrs = [ctypes.c_void_p] * 5
    ints = [ctypes.c_int] * 4
    for fn in (lib.bt_solve_f32, lib.bt_solve_f64):
        fn.argtypes = ptrs + ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bt_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.bt_smem_bytes.restype = ctypes.c_size_t
    lib.bt_smem_optin.argtypes = [ctypes.c_int]
    lib.bt_smem_optin.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _smem_optin(lib: ctypes.CDLL, device_index: int) -> int:
    v = lib.bt_smem_optin(device_index)
    if v < 0:
        raise RuntimeError(f"block_tridiag: cudaDeviceGetAttribute failed (CUDA error {-v})")
    return v


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


def _solve_cuda(D, O, b):
    """The CUDA branch: launch the kernel or raise."""
    lib = _load_library()
    if not (D.is_contiguous() and O.is_contiguous() and b.is_contiguous()):
        raise ValueError("block_tridiag: D, O and b must be contiguous")
    bsz, T, n, _ = D.shape
    x = torch.empty_like(b)
    if bsz == 0:
        return x
    elem = D.element_size()
    all_in_smem = lib.bt_smem_bytes(T, n, elem, 1) <= _smem_optin(lib, D.device.index)
    scratch = None if all_in_smem else torch.empty((bsz, 2, T, n, n), dtype=D.dtype,
                                                   device=D.device)
    fn = lib.bt_solve_f32 if D.dtype == torch.float32 else lib.bt_solve_f64
    err = fn(D.data_ptr(), O.data_ptr(), b.data_ptr(), x.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             bsz, T, n, int(all_in_smem),
             torch.cuda.current_stream(D.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_tridiag: kernel launch failed with CUDA error {err}")
    block_tridiag_solve.launches += 1
    return x


def block_tridiag_solve(D, O, b):
    """Solve H x = b for a batch of SPD block-tridiagonal H.

    D (bsz, T, n, n), O (bsz, T-1, n, n), b (bsz, T, n) -> x (bsz, T, n),
    float32 or float64. A block that is not positive definite gives NaN
    for its sample."""
    _check_args(D, O, b)
    if D.device.type == "cpu":
        return tridiag.block_tridiag_solve(D, O, b)
    if D.device.type != "cuda":
        raise ValueError(f"block_tridiag: unsupported device {D.device}")
    with torch.cuda.device(D.device):
        return _solve_cuda(D, O, b)


block_tridiag_solve.launches = 0
