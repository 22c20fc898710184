"""GHOST core building blocks in PyTorch (paper contributions C1, C3)."""
from repro_torch.core import execution, sellcs, spmv
from repro_torch.core.sellcs import (SellCS, from_callback, from_coo, from_csr,
                                     from_dense, to_dense)
from repro_torch.core.spmv import SpmvOpts, spmv as ghost_spmv, spmv_ref

__all__ = [
    "execution", "sellcs", "spmv",
    "SellCS", "from_callback", "from_coo", "from_csr", "from_dense",
    "to_dense", "SpmvOpts", "ghost_spmv", "spmv_ref",
]
