"""The port's counterparts of the JAX package's scripts and `utils.Spaces`:
`deqmpc_tpu_torch/warmstart_obstacle_aware.py` against
`scripts/warmstart_obstacle_aware.py` leaf for leaf (hdim 32),
`deqmpc_tpu_torch/export_ckpt.py` against `scripts/export_ckpt.py`, and
`training/perf_al_phases.py` and `training/perf_ab.py` run through on the
CPU at a tiny size (their times mean nothing here: the card's are in
PERF.md)."""
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu import utils as jax_utils  # noqa: E402
from deqmpc_tpu.envs import make_env as jax_make_env  # noqa: E402
from deqmpc_tpu.training import train as jax_train  # noqa: E402
from deqmpc_tpu_torch import (export_ckpt, multihost_worker, utils,  # noqa: E402
                              warmstart_obstacle_aware)
from deqmpc_tpu_torch.training import perf_ab, perf_al_phases  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import (load_checkpoint, read_port_checkpoint,  # noqa: E402
                                               save_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HDIM = 32


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [dict(low=[0.0, -1.0], high=[2.0, 3.0]),
                                dict(low=-1.0, high=1.0, shape=(3,)),
                                dict(low=np.zeros((2, 2)), high=None), dict()])
def test_spaces_is_jax_spaces(kw):
    ours, theirs = utils.Spaces(**kw), jax_utils.Spaces(**kw)
    assert ours.shape == theirs.shape
    for side in ("low", "high"):
        a, b = getattr(ours, side), getattr(theirs, side)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def blind_ckpt(tmp_path_factory):
    """A JAX checkpoint of the blind flying policy at hdim 32, its seeded
    init moved by 0.05 N(0, 1) so that no leaf keeps an init value; f32,
    as a trained checkpoint's leaves are."""
    path = tmp_path_factory.mktemp("warm") / "blind"
    base = warmstart_obstacle_aware.BASE + ["--hdim", str(HDIM)]
    args = jax_train.apply_model_type_presets(
        jax_train.build_argparser().parse_args(["--env", "FlyingCartpole", *base]))
    params = jax_train.build_policy(args, jax_make_env("FlyingCartpole")).init(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray((np.asarray(v, np.float64) + 0.05 * rng.normal(size=v.shape))
                              .astype(np.float32)),
        params)
    jax_train.save_checkpoint(str(path), params, None, 11, args)
    return str(path)


@pytest.mark.slow
def test_warmstart_matches_jax_script_leaf_for_leaf(blind_ckpt, tmp_path, monkeypatch):
    """JAX's script at hdim 32 (its command line fixes 256: its parser is
    patched to read 32) and the port's on the same blind checkpoint: every
    leaf equal, the step kept, the aware network at init the blind one."""
    parser = jax_train.build_argparser

    def narrow_parser():
        p = parser()
        parse = p.parse_args

        def parse_args(argv):
            argv = list(argv)
            argv[argv.index("--hdim") + 1] = str(HDIM)
            return parse(argv)

        p.parse_args = parse_args
        return p

    monkeypatch.setattr(jax_train, "build_argparser", narrow_parser)
    monkeypatch.setattr(sys, "argv", ["warmstart", "--src", blind_ckpt,
                                      "--dst", str(tmp_path / "jax_aware")])
    _script("warmstart_obstacle_aware").main()
    out = warmstart_obstacle_aware.main(["--src", blind_ckpt, "--dst", str(tmp_path / "aware"),
                                         "--hdim", str(HDIM), "--device", "cpu"])
    assert out["step"] == 11 and out["init_gap"] < warmstart_obstacle_aware.INIT_TOL
    assert [p[0] for p in out["padded"]] == ["input.Conv_0.kernel"]
    ours, args = load_checkpoint(str(tmp_path / "aware"), "cpu")
    theirs, jargs = load_checkpoint(str(tmp_path / "jax_aware"), "cpu")
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    assert args["obstacle_net_input"] and jargs["obstacle_net_input"]


def test_warmstart_pads_conv0_and_keeps_the_blind_network(blind_ckpt, tmp_path):
    out = warmstart_obstacle_aware.main(["--src", blind_ckpt, "--dst", str(tmp_path / "aware"),
                                         "--hdim", str(HDIM), "--device", "cpu"])
    (name, before, after), = out["padded"]
    assert name == "input.Conv_0.kernel" and after[1] - before[1] == 16
    assert out["init_gap"] < warmstart_obstacle_aware.INIT_TOL
    aware, _ = load_checkpoint(str(tmp_path / "aware"), "cpu")
    blind, _ = load_checkpoint(blind_ckpt, "cpu")
    assert torch.equal(aware[name][:, :before[1]], blind[name])
    assert not aware[name][:, before[1]:].any()


def test_export_matches_jax_script(tmp_path, monkeypatch):
    """A JAX checkpoint exported by both scripts: the same pickle; a port
    checkpoint keeps its weights and loses its optimizer state."""
    src = os.path.join(REPO, "checkpoints", "pendulum_deqmpc")
    ours = export_ckpt.main([src, str(tmp_path / "ours")])
    monkeypatch.setattr(sys, "argv", ["export", src, str(tmp_path / "theirs")])
    _script("export_ckpt").main()
    with open(ours, "rb") as f, open(tmp_path / "theirs" / "pendulum_deqmpc", "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert a == b and a["opt_state"] is None

    policy = multihost_worker.build_policy("cpu")
    opt = torch.optim.Adam(policy.model.parameters())
    sum(p.sum() for p in policy.model.parameters()).backward()
    opt.step()
    full = tmp_path / "port_full"
    save_checkpoint(str(full), policy.model, opt, 5, {"env": "pendulum"})
    blob = read_port_checkpoint(export_ckpt.main([str(full), str(tmp_path / "out")]))
    assert blob["optimizer"] is None and blob["step"] == 5
    for k, v in policy.model.state_dict().items():
        assert torch.equal(blob["model"][k], v)


def test_perf_al_phases_runs_on_the_cpu():
    out = perf_al_phases.main(["--bszs", "4", "--n_rep", "1", "--n_blocks", "1",
                               "--device", "cpu"])
    (row,) = out["rows"]
    assert out["device"]["kind"] == "cpu"
    for key in ("linearize_ms", "assemble_ms", "tridiag_kernel_ms", "tridiag_plain_ms",
                "linesearch20_ms", "al_solve_full_ms"):
        assert np.isfinite(row[key]) and row[key] > 0
    assert 0 < row["fusible_share"] < 1 and row["newton_steps_full"] >= 2


def test_perf_ab_runs_on_the_cpu():
    rows = perf_ab.main(["--env", "pendulum", "--bsz", "2", "--hdim", "16", "--deq_iter", "1",
                         "--n_rep", "1", "--device", "cpu"])
    assert [r["variant"] for r in rows] == ["f32", "bf16"]
    assert all(np.isfinite(r["loss"]) and r["train_step_ms"] > 0 for r in rows)
