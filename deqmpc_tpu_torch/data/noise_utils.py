"""Data-noise augmentation of expert batches (port of
`deqmpc_tpu/data/noise_utils.py`, numpy only).

The noise is drawn from the caller's numpy generator, with the same calls
in the same order as JAX's, so a seeded run draws the same noise:
  0: none
  1: additive Gaussian, `mean + std * N(0, 1)`, on the input observation
  2: the same on the observation, then on every horizon state, returned
     as `state_noisy` (the targets in `state` stay clean)
  3: Gaussian on the observation with the per-dim std of the batch's
     states as its scale
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def add_data_noise(batch: dict, noise_type: int = 0, std: float = 0.05, mean: float = 0.0,
                   rng: Optional[np.random.Generator] = None) -> dict:
    if noise_type == 0:
        return batch
    rng = rng or np.random.default_rng()
    out = dict(batch)
    obs = np.asarray(batch["obs"])
    if noise_type in (1, 2):
        out["obs"] = obs + mean + std * rng.standard_normal(obs.shape).astype(obs.dtype)
        if noise_type == 2:
            st = np.asarray(batch["state"])
            out["state_noisy"] = st + mean + std * rng.standard_normal(st.shape).astype(st.dtype)
    elif noise_type == 3:
        scale = np.std(np.asarray(batch["state"]), axis=(0, 1), keepdims=True)
        out["obs"] = obs + std * scale[0] * rng.standard_normal(obs.shape).astype(obs.dtype)
    else:
        raise ValueError(f"unknown noise_type {noise_type}")
    return out
