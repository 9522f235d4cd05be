"""Expert-trajectory data pipeline, numpy only.

Port of `get_gt_data`, `merge_gt_data` and `sample_trajectory`
(`deqmpc_tpu/data/datagen.py:27-107`): load the expert pickles
(`data/expert_traj_<teacher>-<spec id>_new.pkl`, a list of episodes, each
a list of (state, action) arrays), concatenate them into flat arrays
with a mask that is 0 at each episode's last step, and sample windows of
an H-step history and a T-step horizon from a `numpy.random.Generator`.

The pickles were written by numpy 2 and name `numpy._core.multiarray`;
`load_expert_pickle` maps that module to `numpy.core` under numpy 1, and
unpickles numpy arrays and plain containers only.

Where the port writes: the port's data CLIs (`data/expert_gen.py`,
`data/dagger.py`, `training/sac.py`, `data/golden_traj.py`) never write
into the committed `data/`, which they read only. Their default output
is under `PORT_DATA_DIR` (`<repo>/data_port`, git-ignored), named as JAX
names it (`port_data_path`). `write_episodes` writes a pickle by a
temporary file and a rename; with `append`, a file that does not exist
yet starts from the committed dataset's episodes, so the result is the
pickle JAX's `--append` would have written into `data/`.
"""
from __future__ import annotations

import io
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

DATA_DIR = Path(__file__).resolve().parents[2] / "data"
PORT_DATA_DIR = Path(__file__).resolve().parents[2] / "data_port"
_NUMPY_2 = int(np.__version__.split(".")[0]) >= 2
# the classes an expert pickle may name: numpy's array reconstruction
_ALLOWED = {("numpy._core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "scalar"),
            ("numpy", "ndarray"), ("numpy", "dtype")}


class _ExpertUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        key = (module.replace("numpy.core", "numpy._core"), name)
        if key not in _ALLOWED:
            raise pickle.UnpicklingError(
                f"expert data references {module}.{name}; only numpy arrays are allowed")
        if not _NUMPY_2:
            module = key[0].replace("numpy._core", "numpy.core")
        return super().find_class(module, name)


def load_expert_pickle(path) -> List:
    with open(path, "rb") as f:
        return _ExpertUnpickler(io.BytesIO(f.read())).load()


def expert_data_path(spec_id: str, teacher: str = "mpc") -> Path:
    """`data/expert_traj_<teacher>-<spec id>_new.pkl`."""
    return DATA_DIR / f"expert_traj_{teacher}-{spec_id}_new.pkl"


def port_data_path(spec_id: str, teacher: str = "mpc") -> Path:
    """`data_port/expert_traj_<teacher>-<spec id>_new.pkl`: where the port's
    data CLIs write by default."""
    return PORT_DATA_DIR / f"expert_traj_{teacher}-{spec_id}_new.pkl"


def write_episodes(path, episodes: List, append: bool = False, spec_id: Optional[str] = None,
                   teacher: str = "mpc") -> List:
    """Pickle `episodes` to `path` by a temporary file and a rename (a crash
    mid-dump leaves the old file whole). With `append` the file's episodes
    come first; where it does not exist yet, those of the committed dataset
    of (`spec_id`, `teacher`), if there is one. Returns what was written."""
    path = Path(path)
    if path.resolve().parent == DATA_DIR.resolve():
        raise ValueError(f"{path}: the port never writes into the committed data/")
    if append:
        base = path if path.exists() or spec_id is None else expert_data_path(spec_id, teacher)
        if base.exists():
            episodes = load_expert_pickle(base) + list(episodes)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(episodes, f)
    os.replace(tmp, path)
    return episodes


def get_gt_data(env, teacher: str = "mpc") -> List:
    """The expert episodes of `env` (by its `spec_id`)."""
    path = expert_data_path(env.spec_id, teacher)
    if not path.exists():
        raise FileNotFoundError(f"{path} not found; the JAX package's "
                                "`deqmpc_tpu.data.expert_gen` writes it")
    eps = load_expert_pickle(path)
    if not eps:
        raise ValueError(f"{path} contains no episodes")
    return eps


def merge_gt_data(gt_trajs: List, num_trajs: int = 2_000_000) -> Dict[str, np.ndarray]:
    """Flat float32 arrays of the first `num_trajs` episodes; the mask is 0
    at each episode's last step."""
    states, actions, mask = [], [], []
    for i, traj in enumerate(gt_trajs):
        if i >= num_trajs:
            break
        for s, a in traj:
            states.append(np.asarray(s, np.float32))
            actions.append(np.asarray(a, np.float32))
            mask.append(1.0)
        mask[-1] = 0.0
    return {
        "state": np.stack(states).astype(np.float32),
        "action": np.stack(actions).astype(np.float32),
        "mask": np.asarray(mask, np.float32),
    }


def sample_trajectory(gt: Dict[str, np.ndarray], bsz: int, H: int, T: int,
                      rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
    """bsz random windows: an H-step history ending at the anchor and a
    T-step horizon starting there. A window whose history crosses an
    episode end is rejected; horizon steps past an episode end are zeroed
    by the cumulative product of the mask; a horizon past the data's end
    is zero-padded."""
    rng = rng or np.random.default_rng()
    N = len(gt["state"])
    out = {k: [] for k in ("obs", "obs_action", "state", "action", "mask")}
    count = 0
    while count < bsz:
        idxs = rng.integers(H - 1, N, size=bsz * 4)
        for i in idxs:
            if count >= bsz:
                break
            if H > 1 and np.any(gt["mask"][i + 1 - H: i + 1] == 0):
                continue
            out["obs"].append(gt["state"][i + 1 - H: i + 1])
            out["obs_action"].append(gt["action"][i + 1 - H: i + 1])
            if i + T <= N:
                s, a, m = gt["state"][i: i + T], gt["action"][i: i + T], gt["mask"][i: i + T]
            else:
                pad = i + T - N
                s = np.concatenate([gt["state"][i:],
                                    np.zeros((pad, gt["state"].shape[1]), np.float32)])
                a = np.concatenate([gt["action"][i:],
                                    np.zeros((pad, gt["action"].shape[1]), np.float32)])
                m = np.concatenate([gt["mask"][i:], np.zeros(pad, np.float32)])
            out["state"].append(s)
            out["action"].append(a)
            out["mask"].append(m)
            count += 1
    batch = {k: np.stack(v) for k, v in out.items()}
    batch["mask"] = np.cumprod(batch["mask"], axis=1)
    return batch
