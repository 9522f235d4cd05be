"""deqmpc_tpu_torch: the PyTorch and CUDA port of `deqmpc_tpu` for NVIDIA Hopper.

The JAX package `deqmpc_tpu` is the reference; every module here keeps
the file name of its counterpart there. The port imports torch, numpy
and the standard library only, never jax, flax, optax, msgpack or
`deqmpc_tpu`. The one TPU kernel of the JAX package (the Pallas
block-tridiagonal solve) is a hand-written CUDA kernel here
(`ops/csrc/block_tridiag.cu`).

Public entry points take `device=` and default to the card ("cuda").
They run on the CPU only when the caller asks for it.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Raises when the card is asked
    for and there is none: nothing falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deqmpc_tpu_torch: device 'cuda' was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev
