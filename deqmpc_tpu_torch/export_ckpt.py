"""Export a training checkpoint as a params-only artifact.

Port of `scripts/export_ckpt.py`: the optimizer's state (about twice the
parameters) is dropped, so a committed checkpoint evaluates without it;
it loads through the usual `--load --ckpt` path. A JAX-package
checkpoint (a pickle) stays one, with `opt_state` None, as JAX writes it;
a port checkpoint stays one, with `optimizer` None.

    python -m deqmpc_tpu_torch.export_ckpt model/cartpole_deqmpc [checkpoints/]
"""
from __future__ import annotations

import os
import pickle
import sys
from typing import List, Optional

import torch

from .utils.checkpoint import _restricted_loads, is_port_checkpoint, read_port_checkpoint


def export(src: str, dst_dir: str = "checkpoints") -> str:
    """Write `src` without its optimizer state into `dst_dir` under the
    same name; returns the new path."""
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(dst_dir, os.path.basename(src))
    tmp = f"{dst}.{os.getpid()}.tmp"
    if is_port_checkpoint(src):
        blob = read_port_checkpoint(src)
        torch.save({**blob, "optimizer": None}, tmp)
        step = blob["step"]
    else:
        with open(src, "rb") as f:
            blob = _restricted_loads(f.read())
        out = {"params": blob["params"], "opt_state": None, "step": blob.get("step", 0),
               "args": blob.get("args")}
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        step = out["step"]
    os.replace(tmp, dst)
    print(f"{src} ({os.path.getsize(src) // 2**20} MiB) -> "
          f"{dst} ({os.path.getsize(dst) // 2**20} MiB), step {step}")
    return dst


def main(argv: Optional[List[str]] = None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    return export(argv[0], argv[1] if len(argv) > 1 else "checkpoints")


if __name__ == "__main__":
    main()
