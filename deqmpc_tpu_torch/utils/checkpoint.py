"""Reads the JAX package's checkpoints without JAX, flax or msgpack, and
writes and reads the port's own.

A checkpoint (`deqmpc_tpu/training/train.py:441-490`) is a pickle of a
plain dict: {"params": bytes, "opt_state": bytes | None, "step": int,
"args": dict}. `params` holds flax's msgpack encoding of the parameter
tree: nested maps with string keys and array leaves, each array an ext
value of type 1 that packs (shape, dtype name, raw bytes) with msgpack
again. `msgpack_restore` below decodes that subset of msgpack (maps,
arrays, strings, bin, ints, floats, nil, bool and ext type 1);
`params_from_jax` maps the tree onto the port's `DEQLayer`, or onto the
trunk of `policies/nn_policy.NNPolicy`. `dense_stack_from_jax` and
`dense_stack_to_jax` carry a stack of flax `Dense` layers (the SAC actor,
`Dense_0..3`, and twin critic, `Dense_0..5`, of `training/sac.py`) to and
from a module whose `layers[i]` is `Dense_i`.

A port checkpoint (`save_checkpoint`) is a `torch.save` zip of
{"format", "model" (the `DEQLayer` state dict), "optimizer" (the
optimizer's state dict), "args", "step"}, read back with
`torch.load(weights_only=True)`. `load_checkpoint` reads either kind.
"""
from __future__ import annotations

import io
import os
import pickle
import struct
import zipfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .. import resolve_device

_EXT_NDARRAY = 1


class _Reader:
    """Decoder of one msgpack value from a bytes buffer (big-endian)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _int(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big", signed=True)

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _ext(self, n: int):
        code = self._int(1)
        payload = bytes(self._take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        raise ValueError(f"msgpack: unsupported ext type {code}")

    def value(self) -> Any:
        t = self._uint(1)
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self._take(self._uint(1 << (t - 0xC4))))
        if t in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self._ext(self._uint(1 << (t - 0xC7)))
        if t == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if t == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= t <= 0xCF:  # uint 8/16/32/64
            return self._uint(1 << (t - 0xCC))
        if 0xD0 <= t <= 0xD3:  # int 8/16/32/64
            return self._int(1 << (t - 0xD0))
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self._uint(1 << (t - 0xD9)))
        if t in (0xDC, 0xDD):  # array 16/32
            return self._array(self._uint(2 if t == 0xDC else 4))
        if t in (0xDE, 0xDF):  # map 16/32
            return self._map(self._uint(2 if t == 0xDE else 4))
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def _array(self, n: int):
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _unpack(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode("ascii")
    if dtype_name == "bfloat16":
        raise ValueError("msgpack: bfloat16 arrays are not supported")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape, order="C")


def _unpack(data: bytes) -> Any:
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the value")
    return out


def msgpack_restore(data: bytes) -> Any:
    """Decode flax msgpack bytes into nested dicts of numpy arrays, as
    `flax.serialization.msgpack_restore` does."""
    tree = _unpack(data)

    def check(d):
        if isinstance(d, dict):
            if "__msgpack_chunked_array__" in d:
                raise ValueError("msgpack: chunked arrays are not supported")
            for v in d.values():
                check(v)

    check(tree)
    return tree


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a `DEQLayer` parameter tree of the JAX package
    ({"input": {"params": ...}, "cell": ..., "out": ..., "iter_emb": ...})
    onto the state dict of the port's `models.deq_layer.DEQLayer`, or an
    `NNPolicy` tree ({"params": {"Dense_0": ..., "LayerNorm_0": ..., ...}})
    onto its trunk, `NNPolicy.net`.
    Dense kernels (in, out) become `nn.Linear` weights (out, in); every
    other leaf keeps its layout (UnfoldConv kernels stay (k, Cin, Cout))."""
    state = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path if k == "params" else path + [k])
            return
        arr = np.asarray(node)
        module = path[-2] if len(path) >= 2 else ""
        name = path[-1]
        if module.startswith("Dense_") and name == "kernel":
            arr, name = arr.T, "weight"
        state[".".join(path[:-1] + [name])] = torch.from_numpy(np.array(arr))

    walk(tree, [])
    return state


def dense_stack_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params": {"Dense_i": {"kernel" (in, out), "bias"}}} as numpy ->
    the state dict of a module whose `layers[i]` is an `nn.Linear` (out, in)."""
    params = tree.get("params", tree)
    state = {}
    for name, leaf in params.items():
        if not name.startswith("Dense_"):
            raise ValueError(f"not a stack of Dense layers: {name}")
        i = int(name.split("_")[1])
        state[f"layers.{i}.weight"] = torch.from_numpy(np.array(np.asarray(leaf["kernel"]).T))
        state[f"layers.{i}.bias"] = torch.from_numpy(np.array(leaf["bias"]))
    return state


def dense_stack_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of `dense_stack_from_jax`: flax's tree of numpy arrays."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in state.items():
        _, i, kind = key.split(".")
        leaf = params.setdefault(f"Dense_{i}", {})
        arr = v.detach().cpu().numpy()
        leaf["kernel" if kind == "weight" else "bias"] = arr.T.copy() if kind == "weight" else arr
    return {"params": {k: params[k] for k in sorted(params, key=lambda n: int(n[6:]))}}


def _restricted_loads(data: bytes):
    """Unpickle a checkpoint: plain containers only, no classes."""

    class _PlainUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            raise pickle.UnpicklingError(
                f"checkpoint references {module}.{name}; only plain containers are allowed")

    return _PlainUnpickler(io.BytesIO(data)).load()


def read_checkpoint(path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params tree as numpy, args) of a JAX-package checkpoint."""
    with open(path, "rb") as f:
        blob = _restricted_loads(f.read())
    return msgpack_restore(blob["params"]), dict(blob.get("args") or {})


PORT_FORMAT = "deqmpc_tpu_torch/1"


def save_checkpoint(path, model, optimizer=None, step: int = 0, args=None) -> None:
    """Write a port checkpoint: the model's and the optimizer's state
    dicts, the run's args (plain values) and the step."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {"format": PORT_FORMAT,
            "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "optimizer": optimizer.state_dict() if optimizer is not None else None,
            "args": dict(args or {}), "step": int(step)}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def is_port_checkpoint(path) -> bool:
    """A port checkpoint is a zip (torch.save); a JAX one is a pickle."""
    return zipfile.is_zipfile(path)


def read_port_checkpoint(path) -> Dict[str, Any]:
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if blob.get("format") != PORT_FORMAT:
        raise ValueError(f"{path}: not a {PORT_FORMAT} checkpoint")
    return blob


def checkpoint_step(path) -> int:
    """The training step a checkpoint of either kind was written at."""
    if is_port_checkpoint(path):
        return int(read_port_checkpoint(path)["step"])
    with open(path, "rb") as f:
        return int(_restricted_loads(f.read()).get("step", 0))


def load_checkpoint(path, device="cuda") -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Returns (state dict for the policy's `DEQLayer`, on `device`; args),
    from a JAX-package checkpoint or a port checkpoint."""
    device = resolve_device(device)
    if is_port_checkpoint(path):
        blob = read_port_checkpoint(path)
        state, args = blob["model"], dict(blob["args"])
    else:
        tree, args = read_checkpoint(path)
        state = params_from_jax(tree)
    return {k: v.to(device) for k, v in state.items()}, args
