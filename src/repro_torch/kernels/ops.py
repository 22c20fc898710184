"""Wrappers from a :class:`SellCS` to the port's CUDA kernels.

For CUDA tensors a wrapper launches its kernel or raises; there is no
fallback to the plain version and no switch that turns a kernel off.  For
CPU tensors it runs the kernel's plain version (``kernels/ref.py``),
because a CUDA kernel cannot run there.

Dtype contract: the wrapper passes the matrix' compute dtype
(``compute_dtype=A.dtype``), so a narrower stored value stream is upcast
in registers and products accumulate at full width.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sellcs import SellCS
from repro_torch.core.spmv import SpmvOpts, as2d, x_rows
from repro_torch.kernels.ref import sellcs_spmv_ref
from repro_torch.kernels.sellcs_spmv import sellcs_spmv_cuda

__all__ = ["sellcs_spmv"]


def _col2d(v: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if v is None else as2d(v)[0].contiguous()


def sellcs_spmv(
    A: SellCS,
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    opts: SpmvOpts = SpmvOpts(),
):
    """Fused SELL-C-sigma SpM(M)V.  Vectors in permuted space, ``(n,)`` or
    ``(n, b)``.  Returns ``(y, z, dots)`` like ``core.spmv.spmv_ref``.

    Complex dtypes on CUDA raise ``NotImplementedError``: the complex
    kernel is later work.
    """
    if x.device.type == "cpu":
        return sellcs_spmv_ref(A, x, y, z, opts)
    if A.vals.is_complex() or x.is_complex():
        raise NotImplementedError(
            "sellcs_spmv: complex SpMV has no CUDA kernel yet")
    x2, was1d = as2d(x)
    if x2.shape[0] != x_rows(A):
        raise ValueError(
            f"spmv: x must be permuted/padded to {x_rows(A)} rows, "
            f"got {tuple(x2.shape)}")
    yk, zk, dots = sellcs_spmv_cuda(
        A.vals, A.cols, A.chunk_off, A.chunk_len,
        x2.contiguous(), _col2d(y), _col2d(z) if opts.chain_axpby else None,
        opts.gamma,
        C=A.C, alpha=opts.alpha, beta=opts.beta,
        delta=opts.delta, eta=opts.eta,
        dot_yy=opts.dot_yy, dot_xy=opts.dot_xy, dot_xx=opts.dot_xx,
        compute_dtype=A.dtype)
    if was1d:
        yk = yk[:, 0]
        zk = None if zk is None else zk[:, 0]
    return yk, zk, dots
