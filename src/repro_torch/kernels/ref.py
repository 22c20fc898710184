"""Plain PyTorch versions of the port's CUDA kernels.

Each is the oracle its kernel is held against (on the card in
``chip_smoke.py`` and the ``gpu``-marked tests) and what the kernel
wrappers run for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import blockvec
from repro_torch.core.sellcs import SellCS
from repro_torch.core.spmv import SpmvOpts, spmv_ref, storage_acc_dtype

__all__ = ["sellcs_spmv_ref", "tsmttsm_ref", "tsmm_ref",
           "block_diag_matmul_ref", "fused_axpby_dots_ref"]


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


def block_diag_matmul_ref(blocks: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Plain version of B4: ``y[k*bs:(k+1)*bs] = blocks[k] @ x[k*bs:(k+1)*bs]``
    for ``blocks`` ``(nblocks, bs, bs)`` and ``x`` ``(nblocks*bs, b)``, as a
    broadcast product summed over the block's columns in the accumulation
    dtype, returned in ``promote_types(blocks, x)`` as the kernels return
    it (the JAX reference's einsum returns the same type)."""
    nb, bs, _ = blocks.shape
    out_dtype = torch.promote_types(blocks.dtype, x.dtype)
    acc = storage_acc_dtype(out_dtype)
    xb = x.to(acc).reshape(nb, bs, x.shape[1])
    y = (blocks.to(acc)[:, :, :, None] * xb[:, None, :, :]).sum(dim=2)
    return y.reshape(nb * bs, x.shape[1]).to(out_dtype)


def fused_axpby_dots_ref(x: torch.Tensor, y: torch.Tensor, a=1.0, b=1.0, *,
                         dot_yy: bool = False, dot_xy: bool = False,
                         dot_xx: bool = False):
    """Plain version of B5: ``(a x + b y, dots (3, bw) or None)`` for
    ``(n, bw)`` blocks, with ``a``/``b`` scalars or ``(bw,)``.  ``y'`` and
    the dots are formed in the accumulation dtype of
    ``promote_types(x, y)``; ``y'`` is returned in that promoted dtype, as
    the Pallas kernel returns it (the JAX reference returns ``x``'s)."""
    out_dtype = torch.promote_types(x.dtype, y.dtype)
    acc = storage_acc_dtype(out_dtype)
    xf = x.to(acc)
    ynew = (torch.as_tensor(a, dtype=acc, device=x.device) * xf
            + torch.as_tensor(b, dtype=acc, device=x.device) * y.to(acc))
    dots = None
    if dot_yy or dot_xy or dot_xx:
        zero = torch.zeros(x.shape[1], dtype=acc, device=x.device)
        dots = torch.stack([
            torch.sum(ynew * ynew, dim=0) if dot_yy else zero,
            torch.sum(xf * ynew, dim=0) if dot_xy else zero,
            torch.sum(xf * xf, dim=0) if dot_xx else zero,
        ])
    return ynew.to(out_dtype), dots
