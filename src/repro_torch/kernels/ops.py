"""Wrappers from the port's data structures to its CUDA kernels.

For CUDA tensors a wrapper launches its kernel or raises; there is no
fallback to the plain version and no switch that turns a kernel off.  For
CPU tensors it runs the kernel's plain version (``kernels/ref.py``),
because a CUDA kernel cannot run there.

* ``sellcs_spmv`` — the fused SELL-C-sigma SpM(M)V (kernel B1).  It
  passes the matrix' compute dtype (``compute_dtype=A.dtype``), so a
  narrower stored value stream is upcast in registers and products
  accumulate at full width.
* ``tsmttsm`` / ``tsmm`` / ``tsmm_inplace`` — the tall-skinny GEMMs
  (kernels B2 and B3), with the JAX package's signatures.  Results come in
  ``promote_types`` of the operands and sum in float32 for
  bfloat16/float16.
* ``block_jacobi_apply`` — the batched block-diagonal matmul (kernel B4),
  the block-Jacobi preconditioner's apply.
* ``fused_axpby_dots`` — ``a x + b y`` and its column dots in one sweep
  (kernel B5).  No solver calls it, in either package; it is the op the
  JAX package exposes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.blockvec import check_beta_needs_out
from repro_torch.core.sellcs import SellCS
from repro_torch.core.spmv import SpmvOpts, as2d, x_rows
from repro_torch.kernels.block_diag import block_diag_cuda, check_shapes
from repro_torch.kernels.fused_update import fused_axpby_dots_cuda
from repro_torch.kernels.ref import (block_diag_matmul_ref,
                                     fused_axpby_dots_ref, sellcs_spmv_ref,
                                     tsmm_ref, tsmttsm_ref)
from repro_torch.kernels.sellcs_spmv import sellcs_spmv_cuda
from repro_torch.kernels.tsmm import tsmm_cuda
from repro_torch.kernels.tsmttsm import tsmttsm_cuda

__all__ = ["sellcs_spmv", "tsmttsm", "tsmm", "tsmm_inplace",
           "block_jacobi_apply", "fused_axpby_dots"]


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


def _no_complex(fn: str, *ts) -> None:
    if any(t is not None and t.is_complex() for t in ts):
        raise NotImplementedError(f"{fn}: complex operands have no CUDA "
                                  f"kernel yet")


def tsmttsm(
    V: torch.Tensor,
    W: torch.Tensor,
    X: Optional[torch.Tensor] = None,
    alpha=1.0,
    beta=0.0,
    *,
    kahan: bool = False,
    conj: bool = True,
) -> torch.Tensor:
    """X = alpha V^H W + beta X, ``(m, k)`` in ``promote_types(V, W)``.

    ``kahan=True`` compensates the sum (paper section 5.2).  ``conj``
    matters only for complex V, which runs on the CPU only.
    """
    check_beta_needs_out(beta, X, "tsmttsm")
    if V.device.type == "cpu":
        return tsmttsm_ref(V, W, X, alpha, beta, kahan=kahan, conj=conj)
    _no_complex("tsmttsm", V, W, X)
    return tsmttsm_cuda(V, W, X, alpha, beta, kahan=kahan)


def tsmm(
    V: torch.Tensor,
    X: torch.Tensor,
    W: Optional[torch.Tensor] = None,
    alpha=1.0,
    beta=0.0,
) -> torch.Tensor:
    """W = alpha V X + beta W, ``(n, k)`` in ``promote_types(V, X)``."""
    check_beta_needs_out(beta, W, "tsmm")
    if V.device.type == "cpu":
        return tsmm_ref(V, X, W, alpha, beta)
    _no_complex("tsmm", V, X, W)
    return tsmm_cuda(V, X, W, alpha, beta)


def tsmm_inplace(V: torch.Tensor, X: torch.Tensor, alpha=1.0,
                 beta=0.0) -> torch.Tensor:
    """alpha V X + beta V, returned as a new tensor (V is not written)."""
    return tsmm(V, X, V, alpha=alpha, beta=beta)


def block_jacobi_apply(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply a block-diagonal operator: ``y[blk k] = blocks[k] @ x[blk k]``.

    ``blocks`` is ``(nblocks, bs, bs)``; ``x`` is ``(nblocks*bs,)`` or
    ``(nblocks*bs, b)`` in the matrix' permuted space — the block-Jacobi
    preconditioner apply.  The result has ``promote_types(blocks, x)``.
    Complex dtypes on CUDA raise ``NotImplementedError``.
    """
    x2, was1d = as2d(x)
    check_shapes("block_jacobi_apply", blocks, x2)
    if x2.device.type == "cpu":
        out = block_diag_matmul_ref(blocks, x2)
    else:
        _no_complex("block_jacobi_apply", blocks, x2)
        out = block_diag_cuda(blocks.contiguous(), x2.contiguous())
    return out[:, 0] if was1d else out


def fused_axpby_dots(x: torch.Tensor, y: torch.Tensor, a=1.0, b=1.0, *,
                     dot_yy: bool = False, dot_xy: bool = False,
                     dot_xx: bool = False):
    """``(a*x + b*y, dots)`` in one sweep.  ``x``/``y`` are ``(n,)`` or
    ``(n, bw)``; ``a``/``b`` scalars or ``(bw,)``.  ``dots`` is ``(3, bw)``
    (``(3,)`` for 1-d inputs; rows yy, xy, xx, zeros where not asked) in
    the accumulation dtype, or None when no dot is asked.  The result has
    ``promote_types(x, y)``.  Complex dtypes on CUDA raise
    ``NotImplementedError``.
    """
    x2, was1d = as2d(x)
    y2, _ = as2d(y)
    if x2.device.type == "cpu":
        if tuple(y2.shape) != tuple(x2.shape):
            raise ValueError(f"fused_axpby_dots: y{tuple(y.shape)} must "
                             f"match x{tuple(x.shape)}")
        out, dots = fused_axpby_dots_ref(x2, y2, a, b, dot_yy=dot_yy,
                                         dot_xy=dot_xy, dot_xx=dot_xx)
    else:
        _no_complex("fused_axpby_dots", x2, y2)
        out, dots = fused_axpby_dots_cuda(
            x2.contiguous(), y2.contiguous(), a, b, dot_yy=dot_yy,
            dot_xy=dot_xy, dot_xx=dot_xx)
    if was1d:
        out = out[:, 0]
        dots = None if dots is None else dots[:, 0]
    return out, dots
