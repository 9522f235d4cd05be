"""The CUDA block-tridiagonal kernels against their plain PyTorch version
on the card: the warp kernel (n <= 32, the main path) and the block
kernel (n > 32, or asked for by name). The kernels have no CPU mode, so
these tests skip without a GPU.

The module imports only torch, numpy and the port, so it also runs on a
GPU machine without JAX; there, skip `tests/conftest.py` (which sets up
JAX):

  python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
      tests/test_torch_block_tridiag_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deqmpc_tpu_torch.ops import block_tridiag as bt  # noqa: E402
from deqmpc_tpu_torch.ops import tridiag  # noqa: E402

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs an NVIDIA GPU: the CUDA kernel has no CPU mode"),
]

TOL = {torch.float64: dict(rtol=1e-8, atol=1e-9), torch.float32: dict(rtol=2e-4, atol=2e-4)}


def _problem(bsz, T, n, dtype, seed=0, nonspd=None):
    """An SPD block-tridiagonal system on the card; sample `nonspd` gets a
    negative-definite block."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(bsz, T, n, n))
    D = A @ np.swapaxes(A, -1, -2) + 2.0 * np.eye(n) * (T + 1)
    O = 0.3 * rng.normal(size=(bsz, T - 1, n, n))
    b = rng.normal(size=(bsz, T, n))
    if nonspd is not None:
        D[nonspd, T // 2] = -np.eye(n)
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in (D, O, b)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bsz,T,n", [(1024, 5, 16), (128, 5, 3), (128, 10, 5), (64, 20, 18),
                                     (4, 200, 18)])
def test_kernel_matches_plain_on_card(bsz, T, n, dtype):
    D, O, b = _problem(bsz, T, n, dtype, nonspd=1)
    before = bt.block_tridiag_solve.launches
    x = bt.block_tridiag_solve(D, O, b)
    torch.cuda.synchronize()
    assert bt.block_tridiag_solve.launches == before + 1
    x_ref = tridiag.block_tridiag_solve(D, O, b)
    assert torch.isnan(x[1]).all()
    keep = torch.arange(bsz, device="cuda") != 1
    assert torch.isfinite(x[keep]).all()
    torch.testing.assert_close(x[keep], x_ref[keep], **TOL[dtype])


def _check_against_plain(D, O, b, kernel, nonspd, dtype):
    x = bt.block_tridiag_solve(D, O, b, kernel=kernel)
    torch.cuda.synchronize()
    x_ref = tridiag.block_tridiag_solve(D, O, b)
    keep = torch.ones(D.shape[0], dtype=torch.bool, device="cuda")
    for s in nonspd:
        assert torch.isnan(x[s]).all() and torch.isnan(x_ref[s]).all()
        keep[s] = False
    assert torch.isfinite(x[keep]).all()
    torch.testing.assert_close(x[keep], x_ref[keep], **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bsz,T,n,kernel", [
    (40, 5, 1, "warp"), (40, 5, 32, "warp"), (40, 5, 33, "block"),  # the edges in n
    (40, 1, 16, "warp"), (40, 1, 33, "block"),                      # T = 1
    (33, 5, 16, "warp"),               # bsz not a multiple of the samples per CTA
    (8, 5, 16, "block"), (8, 5, 3, "block"),  # the block kernel asked for by name
])
def test_kernel_edges_match_plain(bsz, T, n, kernel, dtype):
    D, O, b = _problem(bsz, T, n, dtype, seed=3, nonspd=1)
    before = dict(bt.block_tridiag_solve.launches_by_kernel)
    _check_against_plain(D, O, b, None if kernel == "warp" or n > 32 else kernel, [1], dtype)
    after = bt.block_tridiag_solve.launches_by_kernel
    assert after[kernel] == before[kernel] + 1
    assert sum(after.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("where", ["first", "last"])
def test_nonspd_sample_first_or_last_in_its_cta_stays_alone(where, dtype):
    """A CTA of the warp kernel holds 4 samples (warps); a non-SPD sample
    first or last in one must not spread NaN to the others."""
    bsz = 16
    bad = [4, 8] if where == "first" else [3, 7]
    D, O, b = _problem(bsz, 5, 16, dtype, seed=4)
    for s in bad:
        D[s, 2] = -torch.eye(16, dtype=dtype, device="cuda")
    _check_against_plain(D, O, b, None, bad, dtype)


def test_main_path_shape_goes_through_the_warp_kernel():
    D, O, b = _problem(32, 5, 16, torch.float32, seed=5)
    before = dict(bt.block_tridiag_solve.launches_by_kernel)
    bt.block_tridiag_solve(D, O, b)
    after = bt.block_tridiag_solve.launches_by_kernel
    assert after["warp"] == before["warp"] + 1 and after["block"] == before["block"]
