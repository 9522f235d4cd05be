"""A witness of the reference's own: its f64 answers at full width against the
JAX package's, recorded once in `jax_f64_answers.json` (the JAX package's
`DEQMPCPolicy.forward` in f64 on the CPU, from the same checkpoint and the
same seeded start states, six of them). The network's first proposal agrees
to 1e-8 and the median lane's first action to 1e-4. Single lanes may differ
more where a tied line search breaks the other way: on the flying cartpole
two of the six lanes differ by 2.1e-3 and 1.5e-2, and the port's own f64
answers there are the reference's to the bit (PERF.md, Open questions)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.ref import envs, policies
from portbench.ref.utils.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[2]
RECORDED = json.loads((Path(__file__).with_name("jax_f64_answers.json")).read_text())


@pytest.mark.parametrize("ckpt", sorted(RECORDED))
def test_reference_agrees_with_the_jax_package_in_f64(ckpt):
    torch.set_num_threads(4)
    rec = RECORDED[ckpt]
    state, args = load_checkpoint(ROOT / "checkpoints" / ckpt, "cpu")
    env = envs.make_env_of(args)
    policy = policies.build_policy(args, env, "cpu", dtype=torch.float64)
    policy.model.load_state_dict(state)
    obs = torch.tensor(rec["states"], dtype=torch.float64)
    assert torch.equal(obs, env.reset(torch.Generator().manual_seed(rec["seed"]), len(obs),
                                      device="cpu", dtype=torch.float64))
    with torch.inference_mode():
        trajs = policy.forward(obs)["trajs"]
    np.testing.assert_allclose(trajs[0][0].numpy(), rec["proposal"], rtol=1e-8, atol=1e-9)
    gap = np.abs(trajs[-1][2][:, 0].numpy() - np.asarray(rec["action"])).max(axis=-1)
    assert np.isfinite(gap).all()
    assert np.median(gap) <= 1e-4, gap
