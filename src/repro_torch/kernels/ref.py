"""Plain PyTorch versions of the port's CUDA kernels.

Each is the oracle its kernel is held against (on the card in
``chip_smoke.py`` and the ``gpu``-marked tests) and what the kernel
wrappers run for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import blockvec
from repro_torch.core.sellcs import SellCS
from repro_torch.core.spmv import SpmvOpts, spmv_ref

__all__ = ["sellcs_spmv_ref", "tsmttsm_ref", "tsmm_ref"]


def sellcs_spmv_ref(A: SellCS, x, y=None, z=None, opts: SpmvOpts = SpmvOpts()):
    """Plain version of B1: delegates to the core gather + ``index_add_``
    SpMV, which runs on any device."""
    return spmv_ref(A, x, y, z, opts)


def tsmttsm_ref(V, W, X=None, alpha=1.0, beta=0.0, *, kahan: bool = False,
                conj: bool = True):
    """Plain version of B2: ``blockvec.tsmttsm`` (or, with ``kahan``,
    ``blockvec.tsmttsm_kahan``), returned in ``promote_types(V, W)`` as the
    kernel returns it (the sums run in the accumulation dtype)."""
    out_dtype = torch.promote_types(V.dtype, W.dtype)
    if not kahan:
        return blockvec.tsmttsm(V, W, X, alpha=alpha, beta=beta,
                                conj=conj).to(out_dtype)
    blockvec.check_beta_needs_out(beta, X, "tsmttsm")
    # tsmttsm_kahan conjugates a complex V; pre-conjugate to honour
    # conj=False (V^T W instead of V^H W)
    Vk = V.conj() if (not conj and V.is_complex()) else V
    res = alpha * blockvec.tsmttsm_kahan(Vk, W)
    if X is not None:
        res = res + beta * X.to(res.dtype)
    return res.to(out_dtype)


def tsmm_ref(V, X, W=None, alpha=1.0, beta=0.0):
    """Plain version of B3: ``blockvec.tsmm``."""
    return blockvec.tsmm(V, X, W, alpha=alpha, beta=beta)
