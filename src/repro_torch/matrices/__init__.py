"""Test matrices: generators for the paper's application domains + MM IO."""
from repro_torch.matrices import generators, mmio
from repro_torch.matrices.generators import (
    anderson3d, anisotropic_laplace2d, banded_random, graphene, laplace2d,
    laplace3d, matpde, spin_chain_xx,
)
from repro_torch.matrices.mmio import read_matrix_market, write_matrix_market

__all__ = [
    "generators", "mmio", "matpde", "anderson3d", "graphene", "laplace2d",
    "laplace3d", "anisotropic_laplace2d", "banded_random", "spin_chain_xx",
    "read_matrix_market", "write_matrix_market",
]
