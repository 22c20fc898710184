"""Plain PyTorch versions of the port's CUDA kernels.

Each is the oracle its kernel is held against (on the card in
``chip_smoke.py`` and the ``gpu``-marked tests) and what the kernel
wrappers run for CPU tensors.
"""
from __future__ import annotations

from repro_torch.core.sellcs import SellCS
from repro_torch.core.spmv import SpmvOpts, spmv_ref

__all__ = ["sellcs_spmv_ref"]


def sellcs_spmv_ref(A: SellCS, x, y=None, z=None, opts: SpmvOpts = SpmvOpts()):
    """Plain version of B1: delegates to the core gather + ``index_add_``
    SpMV, which runs on any device."""
    return spmv_ref(A, x, y, z, opts)
