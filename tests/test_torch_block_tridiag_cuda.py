"""The CUDA block-tridiagonal kernel against its plain PyTorch version on
the card. The kernel has no CPU mode, so these tests skip without a GPU.

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
