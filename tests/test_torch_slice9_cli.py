"""The train CLI's whole flag surface, the port against the JAX package:
the two parsers' option sets; the `--inner_deq_iters` repair (JAX takes
the flag and never hands it on); training steps of policies that each
package's `build_policy` builds from the same command line (pendulum,
hdim 32, N 2, T 5, bsz 4, f64) under `--kernel_width`, `--deq_reg`,
`--policy_out_type`/`--loss_type` and `--dtype double` with explicit
`--rho_max`/`--rho_init_max`; the cosine schedule and Adam under it
against optax; `--num_trajs_frac`; the data noise and the noised batch
stream; the raw `--deq_type`; and the CLI's loop, metrics, snapshot and
checkpoint under `--start_iter`, `--logdir` and `--save`.

Tolerances: the steps at rtol 1e-9 (loss) and rtol 1e-9, atol 1e-9 of
the largest entry (gradients), as the base step's parity; the C6 forward
and step at 1e-8; the schedule at 1e-15 relative; Adam at atol 1e-12;
the data pipeline exactly."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deqmpc_tpu.data import datagen as jax_datagen  # noqa: E402
from deqmpc_tpu.data import noise_utils as jax_noise  # noqa: E402
from deqmpc_tpu.envs import PendulumEnv as JaxPendulum  # noqa: E402
from deqmpc_tpu.training import train as jax_train  # noqa: E402
from deqmpc_tpu_torch import data as port_data  # noqa: E402
from deqmpc_tpu_torch.data import add_data_noise  # noqa: E402
from deqmpc_tpu_torch.envs import make_env  # noqa: E402
from deqmpc_tpu_torch.policies import build_policy  # noqa: E402
from deqmpc_tpu_torch.training import train  # noqa: E402
from deqmpc_tpu_torch.utils.checkpoint import params_from_jax, read_port_checkpoint  # noqa: E402
from torch_variant_pairs import check_step, pendulum_batch  # noqa: E402

torch.set_num_threads(2)

BASE = ["--env", "pendulum", "--T", "5", "--hdim", "32", "--deq_iter", "2", "--bsz", "4"]
# the solver in f64 at the f32 regime's rho_max, so the step is held at 1e-9
F64 = ["--dtype", "double", "--rho_max", "1e5"]
CASES = {"kernel_width": ["--kernel_width", "5", *F64],
         "deq_reg": ["--deq_reg", "0.3", *F64],
         "out_type_hinge": ["--policy_out_type", "2", "--loss_type", "hinge", *F64],
         "double": ["--dtype", "double", "--rho_max", "1e7", "--rho_init_max", "1e3"]}


def _pair(argv, seed=8):
    """Each package's policy from the same command line, the JAX one with
    its seeded parameters moved by 0.05 N(0, 1) in f64, the port's with the
    same parameters."""
    jargs = jax_train.apply_model_type_presets(jax_train.build_argparser().parse_args(argv))
    pargs = vars(train.parse_args([*argv, "--device", "cpu"]))
    jpol = jax_train.build_policy(jargs, JaxPendulum())
    leaves, treedef = jax.tree_util.tree_flatten(jpol.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(np.asarray(leaf, np.float64) + 0.05 * rng.normal(size=leaf.shape))
        for leaf in leaves])
    pol = build_policy(pargs, make_env("pendulum"), "cpu")
    pol.model.double()
    pol.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jargs, jpol, params, pol


def _jax_step(jargs, jpol, params, batch, moves=()):
    _, loss_fn = jax_train.make_train_step(jpol, None, jargs)
    jbatch = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in batch.items()}
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, aux), grads = step(params, jbatch, jnp.ones((2, 3)))
    moved = []
    rng = np.random.default_rng(1)
    for rel in moves:
        obs = jbatch["obs"] * (1 + rel * rng.normal(size=jbatch["obs"].shape))
        moved.append(step(params, {**jbatch, "obs": obs}, jnp.ones((2, 3)))[1])
    return (params, jbatch, loss, aux, grads), moved


def _port_step(pol, batch):
    d = train.loss_fn(pol, train.to_device(batch, "cpu", torch.float64))
    d["loss"].backward()
    return d


def _np(t):
    return t.detach().cpu().numpy()


# -- the parsers ----------------------------------------------------------------

def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_the_parsers_take_the_same_flags_with_the_same_defaults():
    jax_p, port_p = jax_train.build_argparser(), train.build_argparser()
    assert _options(port_p) - {"--device"} == _options(jax_p)
    assert len(_options(jax_p) - {"-h", "--help"}) == 65
    jd, pd = vars(jax_p.parse_args([])), vars(port_p.parse_args([]))
    assert {k: v for k, v in pd.items() if k != "device"} == jd


# -- C6: --inner_deq_iters is taken and dropped -------------------------------------

def test_inner_deq_iters_is_dropped_as_jax_drops_it():
    """`--fp_type multi --inner_deq_iters 2`: JAX applies the cell 4 times
    (its PolicyConfig has no such field), and so must the port. The same
    policy with a layer that really applies it twice misses the tolerance."""
    argv = [*BASE, *F64, "--fp_type", "multi", "--inner_deq_iters", "2"]
    jargs, jpol, params, pol = _pair(argv)
    assert pol.model.cfg.inner_deq_iters == 4
    batch = pendulum_batch(1)
    obs = np.asarray(batch["obs"][:, -1], np.float64)
    ref, _ = jpol.forward(params, jnp.asarray(obs))
    with torch.no_grad():
        out = pol.forward(torch.as_tensor(obs))
    for k in range(3):
        np.testing.assert_allclose(_np(out["trajs"][-1][k]), np.asarray(ref["trajs"][-1][k]),
                                   rtol=1e-8, atol=1e-8)
    ref_step, _ = _jax_step(jargs, jpol, params, batch)
    d = _port_step(pol, batch)
    np.testing.assert_allclose(_np(d["loss"]), np.asarray(ref_step[2]), rtol=1e-8)
    g_ref = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_step[4]))
    for name, p in pol.model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(_np(g), g_ref[name].numpy(), rtol=1e-8,
                                   atol=1e-8 * float(g_ref[name].abs().max()), err_msg=name)
    # the pre-repair behaviour: the flag reaching the layer
    pol.model.cfg = dataclasses.replace(pol.model.cfg, inner_deq_iters=2)
    with torch.no_grad():
        two = pol.forward(torch.as_tensor(obs))
    gap = np.abs(_np(two["trajs"][-1][1]) - np.asarray(ref["trajs"][-1][1])).max()
    assert gap > 1e-6, gap


# -- train steps from command lines -------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_train_step_matches_jax(case):
    argv = [*BASE, *CASES[case]]
    jargs, jpol, params, pol = _pair(argv)
    if case == "double":
        assert pol.cfg.solver_dtype == torch.float64 and pol.cfg.rho_max == 1e7
        assert pol.rho_warm_max == jpol.rho_warm_max == 1e3
    if case == "kernel_width":
        assert pol.model.state_dict()["cell.Conv_0.kernel"].shape[0] == 5
    batch = pendulum_batch(1)
    ref, _ = _jax_step(jargs, jpol, params, batch)
    d = _port_step(pol, batch)
    assert pol.deq_reg == jpol.cfg.deq_reg and pol.out_type == jpol.cfg.out_type
    assert pol.loss_type == jpol.cfg.loss_type
    check_step(pol, d, ref)


def test_double_at_rho_max_1e8_within_jax_s_own_move():
    """`--dtype double` at its default rho_max 1e8: where the step turns on
    rounding, the port is held within 10x JAX's own move under a 1e-14 move
    of the observations (or 1e-9 where JAX does not move)."""
    argv = [*BASE, "--dtype", "double"]
    jargs, jpol, params, pol = _pair(argv)
    assert pol.cfg.rho_max == 1e8
    batch = pendulum_batch(1)
    ref, (moved,) = _jax_step(jargs, jpol, params, batch, moves=(1e-14,))
    g0 = params_from_jax(jax.tree_util.tree_map(np.asarray, ref[4]))
    g1 = params_from_jax(jax.tree_util.tree_map(np.asarray, moved))
    own = {k: float((g1[k] - g).abs().max() / max(float(g.abs().max()), 1e-300))
           for k, g in g0.items()}
    check_step(pol, _port_step(pol, batch), ref, grad_rel={k: 10 * v for k, v in own.items()})


# -- the cosine schedule and Adam under it ------------------------------------------

def test_cosine_schedule_matches_optax():
    lr, steps = 1e-3, 1000
    ref = optax.warmup_cosine_decay_schedule(init_value=lr * 0.1, peak_value=lr,
                                             warmup_steps=200, decay_steps=steps,
                                             end_value=lr * 0.02)
    sched = train.make_lr_schedule("cosine", lr, steps)
    for count in (0, 1, 199, 200, 201, 600, steps - 1, steps, steps + 5):
        np.testing.assert_allclose(sched(count), float(ref(count)), rtol=1e-15, atol=0,
                                   err_msg=str(count))
    assert train.make_lr_schedule("constant", lr, steps) is None
    with pytest.raises(ValueError, match="positive decay_steps"):
        train.make_lr_schedule("cosine", lr, 200)
    with pytest.raises(ValueError, match="positive decay_steps"):
        optax.warmup_cosine_decay_schedule(lr * 0.1, lr, 200, 200, lr * 0.02)


def test_clipped_adam_under_the_cosine_schedule_matches_optax():
    """Three updates, the schedule indexed by the optimizer's own count.
    optax's `scale_by_schedule` evaluates the schedule at its int32 count,
    which JAX computes in float32 even under x64 (6.3e-7 relative at count
    0, checked below); the port's rate is the schedule's f64 value, so the
    JAX optimizer here takes the same optax schedule at the count cast to
    f64."""
    _, jpol, params, pol = _pair([*BASE, *F64])
    steps = 250
    sched = optax.warmup_cosine_decay_schedule(1e-4, 1e-3, 200, steps, 2e-5)
    port_sched = train.make_lr_schedule("cosine", 1e-3, steps)
    for count in (0, 1, 2, 230):
        r32 = float(sched(jnp.asarray(count, jnp.int32)))
        assert r32 != port_sched(count) and abs(r32 / port_sched(count) - 1) < 1e-6
    jopt = optax.chain(optax.clip_by_global_norm(2.0),
                       optax.adam(lambda count: sched(count.astype(jnp.float64))))
    jstate, jparams = jopt.init(params), params
    opt = train.make_optimizer(pol, 1e-3)
    schedule = train.make_lr_schedule("cosine", 1e-3, steps)
    named = dict(pol.model.named_parameters())
    rng = np.random.default_rng(3)
    for k, scale in enumerate((5.0, 0.5, 1.5)):
        jgrads = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(size=p.shape)), params)
        jgrads = jax.tree_util.tree_map(lambda g: g * scale / optax.global_norm(jgrads), jgrads)
        for name, g in params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads)).items():
            named[name].grad = g.clone()
        assert train.optimizer_updates(opt) == k
        train.set_lr(opt, schedule(train.optimizer_updates(opt)))
        train.clip_by_global_norm_(list(pol.model.parameters()))
        opt.step()
        updates, jstate = jopt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for name, v in params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)).items():
        np.testing.assert_allclose(_np(named[name]), v.numpy(), rtol=0, atol=1e-12, err_msg=name)


# -- the data pipeline ---------------------------------------------------------------

def _episodes(n=30, seed=0):
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=2), rng.normal(size=1)) for _ in range(rng.integers(8, 15))]
            for _ in range(n)]


@pytest.mark.parametrize("frac", [1.0, 0.5, 0.33])
def test_split_episodes_takes_num_trajs_frac(frac):
    eps = _episodes()
    gt, val = train.split_episodes(eps, frac)
    n_train = round(len(eps) * 0.9 * frac)  # `deqmpc_tpu/training/train.py:535-537`
    ref = jax_datagen.merge_gt_data(eps, num_trajs=n_train)
    ref_val = jax_datagen.merge_gt_data(eps[round(-len(eps) * 0.1):])
    for k in ref:
        np.testing.assert_array_equal(gt[k], ref[k])
        np.testing.assert_array_equal(val[k], ref_val[k])


@pytest.mark.parametrize("noise_type", [0, 1, 2, 3])
def test_add_data_noise_matches_jax(noise_type):
    batch = pendulum_batch(1)
    a = add_data_noise(dict(batch), noise_type, 0.05, 0.3, np.random.default_rng(4))
    b = jax_noise.add_data_noise(dict(batch), noise_type, 0.05, 0.3, np.random.default_rng(4))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError):
        add_data_noise(dict(batch), 4, rng=np.random.default_rng(0))


def test_noised_batch_stream_matches_jax():
    """Several steps of the train loop's sampling: preprocess, then noise
    from the sampler's generator, `state_noisy` dropped (`train.py:644-650`)."""
    env = make_env("pendulum")
    gt, _ = train.split_episodes(port_data.get_gt_data(env, "mpc")[:40])
    streams = []
    for prep, noise in ((train.preprocess_batch, add_data_noise),
                        (jax_train.preprocess_batch, jax_noise.add_data_noise)):
        rng, out = np.random.default_rng(0), []
        for _ in range(4):
            b = prep("pendulum", env.nx, port_data.sample_trajectory(gt, 8, 1, 5, rng))
            b = noise(b, 2, 0.05, 0.3, rng)
            b.pop("state_noisy", None)
            out.append(b)
        streams.append(out)
    for a, b in zip(*streams):
        assert set(a) == set(b) and "state_noisy" not in a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the raw switches ------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--deq_type", "nn"], ["--model_type", "deq", "--deq_type", "nn"],
    ["--model_type", "diff-mpc-deq", "--deq", "--qp_solve"],
    ["--model_type", "nn", "--deq", "--lastqp_solve"],
])
def test_raw_switches_follow_the_presets_as_in_jax(argv):
    j = jax_train.apply_model_type_presets(jax_train.build_argparser().parse_args(argv))
    p = train.parse_args(argv)
    for key in ("deq", "deq_type", "qp_solve", "lastqp_solve", "deq_iter"):
        assert getattr(p, key) == getattr(j, key), key
    pol = build_policy(vars(p), make_env("pendulum"), "cpu")
    jpol = jax_train.build_policy(j, JaxPendulum())
    assert type(pol).__name__ == type(jpol).__name__
    assert (pol.cfg.deq_type, pol.cfg.deq_iter) == (jpol.cfg.deq_type, jpol.cfg.deq_iter)
    assert (pol.cfg.qp_solve, pol.cfg.lastqp_solve) == (j.qp_solve, j.lastqp_solve)


# -- the CLI's loop ---------------------------------------------------------------------

JAX_SCALARS = ({"losses/loss_avg", "losses/loss_end", "val_losses/loss_end", "grad_norm",
                "time/per_step"}
               | {f"{g}/{k}{i}" for g, k in (("losses", "loss"), ("losses_opt", "loss_opt"),
                                              ("losses_nn", "loss_nn"),
                                              ("deq_stats", "fwd_err"),
                                              ("deq_stats", "fwd_steps")) for i in range(2)})


def test_train_cli_runs_every_new_flag(tmp_path):
    """The smoke's command line at hdim 16: the loop from --start_iter, the
    rate from the optimizer's count (not the loop's index), the metrics'
    keys, the code snapshot and the checkpoint with its schedule."""
    argv = ["--env", "pendulum", "--deq_iter", "2", "--hdim", "16", "--bsz", "4",
            "--device", "cpu", "--lr_schedule", "cosine", "--data_noise_type", "2",
            "--loss_type", "l2", "--policy_out_type", "2", "--kernel_width", "5",
            "--num_trajs_frac", "0.5", "--start_iter", "201", "--max_train_steps", "205",
            "--val_every", "2", "--warm_start", "", "--save", "--name", "run",
            "--logdir", str(tmp_path / "logs"), "--models_dir", str(tmp_path / "model")]
    res = train.main(argv)
    sched = train.make_lr_schedule("cosine", 1e-3, 205)
    assert res["steps"] == 3 and [r["step"] for r in res["curve"]] == [202, 204]
    # steps 202, 203, 204 take updates 0, 1, 2
    assert [r["lr"] for r in res["curve"]] == [sched(0), sched(2)]
    assert all(np.isfinite(r["loss_avg"]) for r in res["curve"])
    rows = [json.loads(line) for line in open(tmp_path / "logs" / "run" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [202, 204]
    assert all(set(r) - {"step"} == JAX_SCALARS for r in rows)
    assert os.path.isfile(tmp_path / "logs" / "run" / "code" / "deqmpc_tpu_torch" / "training"
                          / "train.py")
    blob = read_port_checkpoint(tmp_path / "model" / "run")
    assert blob["args"]["lr_schedule"] == "cosine" and blob["args"]["kernel_width"] == 5


def test_a_checkpoint_under_the_other_schedule_reinitializes_the_optimizer(tmp_path, capsys):
    common = ["--env", "pendulum", "--deq_iter", "2", "--hdim", "16", "--bsz", "4",
              "--device", "cpu", "--models_dir", str(tmp_path), "--val_every", "1"]
    train.main([*common, "--max_train_steps", "1", "--save", "--name", "c",
                "--logdir", str(tmp_path / "logs")])
    capsys.readouterr()
    train.main([*common, "--max_train_steps", "1", "--load", "--ckpt", "c"])
    assert "reinitialized" not in capsys.readouterr().out
    train.main([*common, "--max_train_steps", "201", "--start_iter", "199", "--load",
                "--ckpt", "c", "--lr_schedule", "cosine"])
    assert "checkpoint optimizer state incompatible; reinitialized" in capsys.readouterr().out


def test_eval_x_window_is_refused_before_the_data_for_an_env_without_it():
    with pytest.raises(SystemExit, match="x_window"):
        train.main(["--env", "pendulum", "--device", "cpu", "--eval_x_window", "0.1,0.1"])


@pytest.mark.parametrize("argv", [
    [], ["--streaming", "--streaming_steps", "2"],
    ["--streaming", "--dtype", "double"],
    ["--streaming", "--rho_max", "1e7", "--rho_init_max", "1e2", "--deq_iter", "2"],
    ["--streaming", "--streaming_start_iter", "10", "--dtype", "double", "--rho_init_max", "1e6"],
])
def test_streaming_schedule_reads_rho_max_and_rho_init_max(argv):
    """The JAX CLI's schedule (`deqmpc_tpu/training/train.py:507-518`),
    computed here from JAX's parsed args."""
    j = jax_train.apply_model_type_presets(jax_train.build_argparser().parse_args(argv))
    rho_max = j.rho_max or (1e8 if j.dtype == "double" else 1e5)
    rho_warm = min(j.rho_init_max, rho_max * 1e-4)
    str_al_iter = min(int(np.log10(rho_max * 100 / rho_warm) / 2), j.deq_iter)
    total = j.deq_iter + (str_al_iter * j.streaming_steps
                          if j.streaming and j.streaming_start_iter == 0 else 0)
    p = train.parse_args(argv)
    assert train.streaming_schedule(p) == total and p.str_al_iter == str_al_iter


def test_start_iter_moves_the_pretrain_gate(capsys):
    """`--pretrain` runs the network alone until step 5000; a run that
    starts at 4999 is past the gate from its first step, one that starts at
    4998 switches at 5000 (`train.py:616-617,629`)."""
    common = ["--env", "pendulum", "--deq_iter", "2", "--hdim", "16", "--bsz", "4",
              "--device", "cpu", "--pretrain", "--val_every", "1", "--max_train_steps", "5001"]
    rows = train.main([*common, "--start_iter", "4998"])["curve"]
    assert [(r["step"], r["pretrain"]) for r in rows] == [(4999, True), (5000, False)]
    assert "[5000] pretrain done" in capsys.readouterr().out
    rows = train.main([*common, "--start_iter", "4999"])["curve"]
    assert [(r["step"], r["pretrain"]) for r in rows] == [(5000, False)]
    assert "pretrain done" not in capsys.readouterr().out
