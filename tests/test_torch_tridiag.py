"""The port's block-tridiagonal solve against the JAX package.

The plain PyTorch version (`deqmpc_tpu_torch/ops/tridiag.py`) is held
against JAX's `block_tridiag_solve` and the Pallas kernel in interpret
mode; the CUDA kernel is held against the plain version on the card by
`tests/test_torch_block_tridiag_cuda.py` and `chip_smoke.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deqmpc_tpu.ops.pallas_tridiag import pallas_block_tridiag_solve  # noqa: E402
from deqmpc_tpu.ops.tridiag import block_tridiag_dense as jax_dense  # noqa: E402
from deqmpc_tpu.ops.tridiag import block_tridiag_solve as jax_solve  # noqa: E402
from deqmpc_tpu_torch.ops import block_tridiag as bt  # noqa: E402
from deqmpc_tpu_torch.ops import tridiag  # noqa: E402

torch.set_num_threads(2)

# shapes of tests/test_pallas_tridiag.py plus the T=20, n=18 horizon the
# Pallas kernel could not hold in VMEM
SHAPES = [(4, 5, 3), (130, 5, 3), (8, 5, 16), (16, 1, 4), (64, 20, 18)]
# Pallas interpret mode takes about 100 s at (64, 20, 18) on the CPU, so
# that shape is held against the XLA scan version only
PALLAS_SHAPES = SHAPES[:4]
TOL = {np.float64: dict(rtol=1e-8, atol=1e-9), np.float32: dict(rtol=2e-4, atol=2e-4)}


def _problem(bsz, T, n, seed=0, nonspd=None):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(bsz, T, n, n))
    D = A @ np.swapaxes(A, -1, -2) + 2.0 * np.eye(n) * (T + 1)
    O = 0.3 * rng.normal(size=(bsz, max(T - 1, 0), n, n))
    b = rng.normal(size=(bsz, T, n))
    if nonspd is not None:
        D[nonspd, T // 2] = -np.eye(n)
    return D, O, b


def _torch(*arrays, dtype=torch.float64):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("bsz,T,n", SHAPES)
def test_plain_matches_jax_solve(bsz, T, n, dtype):
    D, O, b = (a.astype(dtype) for a in _problem(bsz, T, n))
    x_ref = np.asarray(jax_solve(jnp.asarray(D), jnp.asarray(O), jnp.asarray(b)))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    x = bt.block_tridiag_solve(*_torch(D, O, b, dtype=tdt))
    assert x.dtype == tdt
    np.testing.assert_allclose(x.numpy(), x_ref, **TOL[dtype])


@pytest.mark.parametrize("bsz,T,n", PALLAS_SHAPES)
def test_plain_matches_pallas_interpret(bsz, T, n):
    D, O, b = _problem(bsz, T, n, seed=1)
    x_pl = np.asarray(pallas_block_tridiag_solve(
        jnp.asarray(D), jnp.asarray(O), jnp.asarray(b), interpret=True))
    x = tridiag.block_tridiag_solve(*_torch(D, O, b))
    np.testing.assert_allclose(x.numpy(), x_pl, **TOL[np.float64])


@pytest.mark.parametrize("bsz,T,n", [(6, 5, 3), (6, 5, 16)])
def test_non_spd_sample_is_nan_and_neighbours_finite(bsz, T, n):
    D, O, b = _problem(bsz, T, n, nonspd=2)
    x_ref = np.asarray(jax_solve(jnp.asarray(D), jnp.asarray(O), jnp.asarray(b)))
    x = bt.block_tridiag_solve(*_torch(D, O, b)).numpy()
    assert np.isnan(x_ref[2]).all() and np.isnan(x[2]).all()
    keep = np.arange(bsz) != 2
    assert np.isfinite(x[keep]).all()
    np.testing.assert_allclose(x[keep], x_ref[keep], **TOL[np.float64])


@pytest.mark.parametrize("bsz,T,n", SHAPES)
def test_matvec_of_solve_is_rhs(bsz, T, n):
    D, O, b = _torch(*_problem(bsz, T, n, seed=2))
    x = bt.block_tridiag_solve(D, O, b)
    np.testing.assert_allclose(tridiag.block_tridiag_matvec(D, O, x).numpy(), b.numpy(),
                               rtol=1e-9, atol=1e-9)


def test_dense_matches_jax_and_solves():
    D, O, b = _problem(3, 4, 5, seed=3)
    H = tridiag.block_tridiag_dense(*_torch(D, O))
    np.testing.assert_array_equal(H.numpy(), np.asarray(jax_dense(jnp.asarray(D), jnp.asarray(O))))
    x = tridiag.block_tridiag_solve(*_torch(D, O, b))
    np.testing.assert_allclose(torch.linalg.solve(H, torch.as_tensor(b).reshape(3, -1)).numpy(),
                               x.reshape(3, -1).numpy(), rtol=1e-9, atol=1e-10)


def test_cuda_branch_raises_when_library_cannot_load(monkeypatch):
    """The CUDA branch of the dispatch launches the kernel or raises: it has
    no fallback to the plain version."""
    def broken_loader():
        raise OSError("libblock_tridiag.so: cannot open shared object file")

    monkeypatch.setattr(bt, "_load_library", broken_loader)
    D, O, b = _torch(*_problem(2, 3, 3))
    before = bt.block_tridiag_solve.launches
    with pytest.raises(OSError, match="cannot open"):
        bt._solve_cuda(D, O, b)
    assert bt.block_tridiag_solve.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(bt, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bt.build()


@pytest.mark.parametrize("bad", ["shape_O", "shape_b", "dtype", "square"])
def test_wrapper_checks_its_arguments(bad):
    D, O, b = _torch(*_problem(2, 3, 4))
    if bad == "shape_O":
        O = O[:, :1]
    elif bad == "shape_b":
        b = b[..., :3]
    elif bad == "dtype":
        b = b.float()
    else:
        D = D[..., :3]
    with pytest.raises((ValueError, TypeError)):
        bt.block_tridiag_solve(D, O, b)


def test_cpu_path_does_not_count_launches():
    before = bt.block_tridiag_solve.launches
    bt.block_tridiag_solve(*_torch(*_problem(2, 3, 3)))
    assert bt.block_tridiag_solve.launches == before

