"""Wrappers from the port's data structures to its CUDA kernels.

For CUDA tensors a wrapper launches its kernel or raises; there is no
fallback to the plain version and no switch that turns a kernel off.  For
CPU tensors it runs the kernel's plain version (``kernels/ref.py``),
because a CUDA kernel cannot run there.  A conjugate view (``t.conj()``,
which torch keeps as a flag over the unconjugated values, and which
``contiguous()`` leaves as it is) is resolved before a kernel reads its
values (``_own``).

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
* ``herm_eig`` — the eigendecomposition of a small Hermitian matrix
  (the port's own kernel, which replaces no TPU kernel: on the card
  ``torch.linalg.eigh`` checks its ``info`` on the host, so the
  block-Krylov solvers' (b, b) eigensolves go through this one).
* ``mamba_scan`` — the selective-SSM scan of the Mamba mixer (kernel B6).
  It has no ``d_tile`` or ``s_blk`` and pads nothing: the CUDA kernel
  takes any shape and any state size, in float32 only.

B1–B5 take complex64 and complex128 operands on the card as they take
real ones.

Mixed operand dtypes (B1–B4).  Each wrapper returns what the JAX
package's op returns, ``promote_types`` of the pair (B1: of the matrix'
compute dtype and ``x``; B2: of V and W; B3: of V and X; B4: of the blocks
and ``x``), on the card as on the CPU.  A pair reaches a kernel instance
or an exact conversion here:

* B1: ``x`` widened to the result dtype (exact: the result is at least
  ``x``'s); the values stay as stored and the kernel reads them in the
  result dtype, an instance for every stored dtype that promotes to it,
  so a real matrix on complex vectors is a real value stream under a
  complex compute dtype (two fused multiply-adds a product, complex
  alpha, beta, gamma, delta, eta and dots as for complex values), and a
  complex64 matrix under complex128 x widens its values in registers.
  ``y`` and ``z`` are taken in the result dtype as the JAX kernel takes
  them (``astype``); a ``z`` wider than the result raises, as it would
  widen the chained output on the CPU.
* B2: V and W widened to the result dtype (exact), then one instance.
* B3: X no wider than V is converted in the wrapper (exact); a wider X
  widens V to the result dtype (exact; a copy of V); W is taken in the
  result dtype.
* B4: real blocks with complex ``x``: a real product over ``x``'s
  interleaved (re, im) columns (``torch.view_as_real``), exact since no
  coefficient mixes the two parts; complex blocks with ``x`` of another
  precision: ``x`` widened (exact), and complex64 blocks with complex128
  ``x`` (or float64 ``x``, widened to complex128) an instance that widens
  the blocks as it reads them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.blockvec import check_beta_needs_out
from repro_torch.core.sellcs import SellCS
from repro_torch.core.spmv import SpmvOpts, as2d, x_rows
from repro_torch.kernels.block_diag import (REAL_OF, block_diag_cuda,
                                            check_shapes)
from repro_torch.kernels.fused_update import fused_axpby_dots_cuda
from repro_torch.kernels.herm_eig import herm_eig_cuda
from repro_torch.kernels.mamba_scan import check_shapes as scan_shapes
from repro_torch.kernels.mamba_scan import mamba_scan_cuda
from repro_torch.kernels.ref import (block_diag_matmul_ref,
                                     fused_axpby_dots_ref, mamba_scan_ref,
                                     sellcs_spmv_ref, tsmm_ref, tsmttsm_ref)
from repro_torch.kernels.sellcs_spmv import sellcs_spmv_cuda
from repro_torch.kernels.tsmm import tsmm_cuda
from repro_torch.kernels.tsmttsm import tsmttsm_cuda

__all__ = ["sellcs_spmv", "tsmttsm", "tsmm", "tsmm_inplace",
           "block_jacobi_apply", "fused_axpby_dots", "herm_eig",
           "mamba_scan"]


def _own(*ts):
    """The tensors with their conjugate flags resolved (``None`` kept)."""
    return tuple(None if t is None else t.resolve_conj() for t in ts)


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

    The result has ``promote_types(A.dtype, x.dtype)``, the JAX op's
    dtype, for any pair (see the module's note): ``x`` is widened to it
    and the kernel reads the stored values in it.
    """
    if x.device.type == "cpu":
        return sellcs_spmv_ref(A, x, y, z, opts)
    x, y, z = _own(x, y, z)
    out = torch.promote_types(A.dtype, x.dtype)
    if not opts.chain_axpby:
        z = None
    elif z is not None and torch.promote_types(z.dtype, out) != out:
        raise TypeError(f"sellcs_spmv: z ({z.dtype}) is wider than the "
                        f"result dtype {out}")
    x, y, z = (_as_dtype(v, out) for v in (x, y, z))
    x2, was1d = as2d(x)
    if x2.shape[0] != x_rows(A):
        raise ValueError(
            f"spmv: x must be permuted/padded to {x_rows(A)} rows, "
            f"got {tuple(x2.shape)}")
    yk, zk, dots = sellcs_spmv_cuda(
        A.vals, A.cols, A.chunk_off, A.chunk_len,
        x2.contiguous(), _col2d(y), _col2d(z),
        opts.gamma,
        C=A.C, alpha=opts.alpha, beta=opts.beta,
        delta=opts.delta, eta=opts.eta,
        dot_yy=opts.dot_yy, dot_xy=opts.dot_xy, dot_xx=opts.dot_xx,
        compute_dtype=out)
    if was1d:
        yk = yk[:, 0]
        zk = None if zk is None else zk[:, 0]
    return yk, zk, dots


def _as_dtype(v: Optional[torch.Tensor], dt: torch.dtype):
    """``v`` in ``dt`` (``None`` kept): exact where ``dt`` is its result
    dtype with another operand; a complex ``v`` for a real ``dt`` keeps its
    real part, as the JAX kernels' ``astype`` does."""
    if v is None or v.dtype == dt:
        return v
    if v.is_complex() and not dt.is_complex:
        v = v.real
    return v.to(dt)


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
    matters only for complex V: ``V^H W`` with it, ``V^T W`` without.
    V and W of different dtypes are widened to the result dtype (exact).
    """
    check_beta_needs_out(beta, X, "tsmttsm")
    if V.device.type == "cpu":
        return tsmttsm_ref(V, W, X, alpha, beta, kahan=kahan, conj=conj)
    V, W = _own(V, W)
    out = torch.promote_types(V.dtype, W.dtype)
    return tsmttsm_cuda(_as_dtype(V, out), _as_dtype(W, out), X, alpha,
                        beta, kahan=kahan, conj=conj)


def tsmm(
    V: torch.Tensor,
    X: torch.Tensor,
    W: Optional[torch.Tensor] = None,
    alpha=1.0,
    beta=0.0,
) -> torch.Tensor:
    """W = alpha V X + beta W, ``(n, k)`` in ``promote_types(V, X)``
    (an X wider than V widens V, exactly; W is taken in the result
    dtype)."""
    check_beta_needs_out(beta, W, "tsmm")
    if V.device.type == "cpu":
        return tsmm_ref(V, X, W, alpha, beta)
    V, W = _own(V, W)
    out = torch.promote_types(V.dtype, X.dtype)
    return tsmm_cuda(_as_dtype(V, out), X, _as_dtype(W, out), alpha, beta)


def tsmm_inplace(V: torch.Tensor, X: torch.Tensor, alpha=1.0,
                 beta=0.0) -> torch.Tensor:
    """alpha V X + beta V, returned as a new tensor (V is not written)."""
    return tsmm(V, X, V, alpha=alpha, beta=beta)


def block_jacobi_apply(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply a block-diagonal operator: ``y[blk k] = blocks[k] @ x[blk k]``.

    ``blocks`` is ``(nblocks, bs, bs)``; ``x`` is ``(nblocks*bs,)`` or
    ``(nblocks*bs, b)`` in the matrix' permuted space — the block-Jacobi
    preconditioner apply.  The result has ``promote_types(blocks, x)``
    for any pair (see the module's note).
    """
    x2, was1d = as2d(x)
    check_shapes("block_jacobi_apply", blocks, x2)
    if x2.device.type == "cpu":
        out = block_diag_matmul_ref(blocks, x2)
    else:
        blocks, x2 = _own(blocks.contiguous(), x2.contiguous())
        if x2.is_complex() and not blocks.is_complex():
            # real blocks times x's (re, im) columns: (n, 2b) real
            n, b = (int(s) for s in x2.shape)
            yr = block_diag_cuda(blocks, torch.view_as_real(x2).reshape(
                n, 2 * b))
            out = torch.view_as_complex(yr.view(n, b, 2))
        else:
            out = block_diag_cuda(blocks, _as_dtype(x2, _b4_x_dtype(
                blocks.dtype, x2.dtype)).contiguous())
    return out[:, 0] if was1d else out


def _b4_x_dtype(bd: torch.dtype, xd: torch.dtype) -> torch.dtype:
    """The dtype B4's kernel takes ``x`` in beside blocks of ``bd``: as it
    is for real blocks; for complex blocks their dtype or, for a real
    ``x``, their precision's real dtype, and complex128 where the result
    is wider than the blocks (complex64 blocks widened as they are read)."""
    if not bd.is_complex:
        return xd
    out = torch.promote_types(bd, xd)
    if out != bd:
        return out
    return bd if xd.is_complex else REAL_OF[bd]


def fused_axpby_dots(x: torch.Tensor, y: torch.Tensor, a=1.0, b=1.0, *,
                     dot_yy: bool = False, dot_xy: bool = False,
                     dot_xx: bool = False):
    """``(a*x + b*y, dots)`` in one sweep.  ``x``/``y`` are ``(n,)`` or
    ``(n, bw)``; ``a``/``b`` scalars or ``(bw,)``.  ``dots`` is ``(3, bw)``
    (``(3,)`` for 1-d inputs; rows yy, xy, xx, zeros where not asked) in
    the accumulation dtype, or None when no dot is asked.  The result has
    ``promote_types(x, y)``.  Complex dots are conjugate-linear in their
    first argument (``<x, y'> = sum conj(x) y'``), where the JAX package's
    plain path sums ``x y'`` (a deliberate difference).
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
        x2, y2 = _own(x2, y2)
        out, dots = fused_axpby_dots_cuda(
            x2.contiguous(), y2.contiguous(), a, b, dot_yy=dot_yy,
            dot_xy=dot_xy, dot_xx=dot_xx)
    if was1d:
        out = out[:, 0]
        dots = None if dots is None else dots[:, 0]
    return out, dots


def herm_eig(A: torch.Tensor):
    """``(w, U, converged)`` with ``A = U diag(w) U^H``, ``w`` ascending,
    for a Hermitian ``(m, m)`` or ``(batch, m, m)`` ``A`` (its lower
    triangle is read).  CUDA tensors launch the port's Jacobi kernel
    (any ``m``; ``converged`` is a bool tensor on the card, False where
    the kernel's sweep limit was reached, and nothing runs instead); CPU
    tensors take ``torch.linalg.eigh``, which raises where it fails, so
    ``converged`` is True there.  Eigenvectors are fixed only up to a
    phase and within a repeated eigenvalue's space, so the two may give
    different U.
    """
    if A.device.type == "cpu":
        w, U = torch.linalg.eigh(A)
        return w, U, torch.ones(A.shape[:-2], dtype=torch.bool)
    w, U, sweeps = herm_eig_cuda(A)
    return w, U, sweeps > 0


def mamba_scan(dt: torch.Tensor, xc: torch.Tensor, Bc: torch.Tensor,
               Cc: torch.Tensor, A: torch.Tensor, *,
               impl: Optional[str] = None) -> torch.Tensor:
    """State-resident selective scan: ``y[b,s,d] = sum_n h[b,s,d,n]
    Cc[b,s,n]`` with ``h = exp(dt A) h + dt xc Bc``, recurrent over s.

    ``dt``, ``xc`` ``(B, S, di)``; ``Bc``, ``Cc`` ``(B, S, N)``; ``A``
    ``(di, N)``.  CUDA tensors launch kernel B6 (float32 only; anything
    else raises), on contiguous copies of
    strided operands; CPU tensors, or
    ``impl="ref"``, run the plain version in the inputs' dtype.
    """
    if impl not in (None, "ref"):
        raise ValueError(f"mamba_scan: impl must be None or 'ref', got "
                         f"{impl!r}")
    scan_shapes("mamba_scan", dt, xc, Bc, Cc, A)
    if impl == "ref" or dt.device.type == "cpu":
        return mamba_scan_ref(dt, xc, Bc, Cc, A)
    return mamba_scan_cuda(*(t.contiguous() for t in (dt, xc, Bc, Cc, A)))
