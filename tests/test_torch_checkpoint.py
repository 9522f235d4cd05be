"""The port's checkpoint reader against flax, and the full-width DEQ
network of `checkpoints/rexquad_deqmpc` against JAX's, with no solver."""
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from deqmpc_tpu.models.deq_layer import DEQLayer as JaxDEQLayer  # noqa: E402
from deqmpc_tpu.models.deq_layer import DEQLayerConfig as JaxDEQLayerConfig  # noqa: E402
from deqmpc_tpu_torch.models import DEQLayer, DEQLayerConfig  # noqa: E402
from deqmpc_tpu_torch.utils import checkpoint  # noqa: E402

torch.set_num_threads(2)

CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / "rexquad_deqmpc"
# f32 on both sides, ~5M parameters, 13 cell applications: the two
# frameworks sum the 3072-long conv contractions in different orders
# (about 1e-6 relative each), and Anderson's mixing amplifies that.
# On the CPU the gap is about a tenth of this bound (z entries reach 7.7).
F32_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def blob():
    with open(CKPT, "rb") as f:
        return pickle.load(f)


def test_reader_is_bit_identical_to_flax(blob):
    ref = serialization.msgpack_restore(blob["params"])
    tree, args = checkpoint.read_checkpoint(CKPT)
    assert args == blob["args"]
    leaves_ref = jax.tree_util.tree_leaves_with_path(ref)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in leaves] == [p for p, _ in leaves_ref]
    for (path, a), (_, b) in zip(leaves, leaves_ref):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    assert sum(a.size for _, a in leaves) == 4940044


@pytest.mark.parametrize("value", [0, 1, 127, -1, -32, -33, 255, 65536, -70000, 2**40,
                                   1.5, -2.25, True, None, "x" * 40, b"\x00\x01",
                                   [1, [2, "a"]], {"k": {"n": 3}}])
def test_msgpack_subset_round_trips(value):
    import msgpack  # the port reads without it; the test writes with it

    assert checkpoint.msgpack_restore(msgpack.packb(value, use_bin_type=True)) == value


def test_reader_refuses_pickled_classes(tmp_path):
    path = tmp_path / "bad"
    path.write_bytes(pickle.dumps({"params": b"", "args": {"f": np.float64(1.0)}}))
    with pytest.raises(pickle.UnpicklingError, match="only plain containers"):
        checkpoint.read_checkpoint(path)


def test_load_checkpoint_without_a_card_raises_when_no_device_is_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        checkpoint.load_checkpoint(CKPT)


def test_full_width_network_matches_jax_in_f32(blob):
    args = blob["args"]
    kw = dict(nx=12, nu=4, nq=args["nq"], T=args["T"], dt=0.05, hdim=args["hdim"],
              deq_iter=args["deq_iter"], fp_max_steps=args["max_steps"], fp_m=args["m"])
    params = serialization.msgpack_restore(blob["params"])
    state, _ = checkpoint.load_checkpoint(CKPT, "cpu")
    layer = DEQLayer(DEQLayerConfig(**kw))
    layer.load_state_dict(state)

    rng = np.random.default_rng(0)
    obs = (0.5 * rng.normal(size=(8, 12))).astype(np.float32)
    x_prev = np.repeat(obs[:, None], args["T"], axis=1)
    z0 = np.zeros((8, args["T"] - 1, args["hdim"]), np.float32)
    # z0 is passed in f32: the suite runs JAX with x64 on, and a default
    # jnp.zeros would lift the whole JAX forward to f64
    out_ref, aux_ref = jax.jit(JaxDEQLayer(JaxDEQLayerConfig(**kw)).__call__)(
        params, {"o": jnp.asarray(obs)}, {"x": jnp.asarray(x_prev), "z": jnp.asarray(z0)})
    assert aux_ref["z"].dtype == jnp.float32
    with torch.inference_mode():
        out, z = layer(*(torch.as_tensor(a) for a in (obs, x_prev, z0)))
    assert z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), np.asarray(aux_ref["z"]), **F32_TOL)
    np.testing.assert_allclose(out["x_ref"].numpy(), np.asarray(out_ref["x_ref"]), **F32_TOL)
