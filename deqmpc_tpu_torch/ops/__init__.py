"""Block-tridiagonal SPD solve: the CUDA kernel's wrapper and its plain version."""
from .block_tridiag import block_tridiag_solve

__all__ = ["block_tridiag_solve"]
