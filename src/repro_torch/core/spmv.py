"""Augmented, fused SpM(M)V (paper C1 + C3), in PyTorch.

The single entry point mirrors GHOST's ``ghost_spmv(y, A, x, opts)``:

    y = alpha * (A - gamma*I) @ x + beta * y          (VSHIFT: gamma per column)
    z = delta * z + eta * y                            (chained AXPBY)
    dots = [<y,y>, <x,y>, <x,x>]  (per block-vector column, float64 acc)

``x``/``y``/``z`` are single vectors ``(n,)`` or block vectors ``(n, b)``
(row-major interleaved storage — paper section 5.2), in the matrix'
permuted space of ``nrows_pad`` rows.  A non-square matrix (a rectangular
part) takes ``x`` with ``ncols`` rows; the shift and the x-dots need a
square part and raise there.

Two executors:
  * ``impl="ref"``  — the plain PyTorch version (gather + ``index_add_``),
    on any device;
  * ``impl="cuda"`` — the hand-written CUDA kernel
    (``repro_torch.kernels.ops.sellcs_spmv``); CPU tensors take the plain
    version there.
``impl=None`` picks the kernel for CUDA tensors and the plain version for
CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.sellcs import SellCS

__all__ = ["SpmvOpts", "as2d", "pack_coefs", "spmv", "spmv_ref",
           "dot_acc_dtype", "storage_acc_dtype", "fused_dots", "x_rows"]


def storage_acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Accumulator dtype for an operand/output dtype: bfloat16/float16 are
    storage formats that accumulate in float32; wider types natively."""
    if dt in (torch.bfloat16, torch.float16):
        return torch.float32
    return dt


@dataclasses.dataclass(frozen=True)
class SpmvOpts:
    """Fusion flags for the augmented SpMV (GHOST ``ghost_spmv_opts``)."""

    alpha: float | torch.Tensor = 1.0
    beta: float | torch.Tensor = 0.0         # y = alpha*Ax + beta*y
    gamma: Optional[object] = None           # scalar or (b,) per-column shift
    delta: Optional[float | torch.Tensor] = None   # z = delta*z + eta*y
    eta: Optional[float | torch.Tensor] = None
    dot_yy: bool = False
    dot_xy: bool = False
    dot_xx: bool = False

    @property
    def any_dot(self) -> bool:
        return self.dot_yy or self.dot_xy or self.dot_xx

    @property
    def chain_axpby(self) -> bool:
        return self.delta is not None or self.eta is not None


def pack_coefs(opts: SpmvOpts, nvecs: int, dtype: torch.dtype,
               device=None) -> torch.Tensor:
    """Pack (alpha, beta, gamma) into a ``(3, nvecs)`` tensor."""
    c = torch.zeros((3, nvecs), dtype=dtype, device=device)
    c[0] = torch.as_tensor(opts.alpha, dtype=dtype, device=device)
    c[1] = torch.as_tensor(opts.beta, dtype=dtype, device=device)
    if opts.gamma is not None:
        c[2] = torch.as_tensor(opts.gamma, dtype=dtype, device=device)
    return c


def as2d(v: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """Promote a single vector to a 1-column block vector.
    Returns ``(v2d, was1d)``."""
    if v.ndim == 1:
        return v[:, None], True
    return v, False


def x_rows(A: SellCS) -> int:
    """Rows of the ``x`` an SpMV with ``A`` takes: ``nrows_pad`` for a
    square matrix, ``ncols`` for a rectangular part."""
    return A.nrows_pad if A.nrows == A.ncols else A.ncols


def dot_acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype of the fused dots: float64, or complex128 for
    complex inputs (torch always has 64-bit types, so the port takes the
    JAX package's x64 branch)."""
    return torch.complex128 if dt.is_complex else torch.float64


def _acc_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> per column with the conjugated first argument, in float64."""
    ddt = dot_acc_dtype(torch.promote_types(a.dtype, b.dtype))
    return torch.sum(torch.conj(a.to(ddt)) * b.to(ddt), dim=0)


def fused_dots(x2: torch.Tensor, y2: torch.Tensor,
               opts: SpmvOpts) -> torch.Tensor:
    """The ``(3, b)`` fused-dot bundle ``[<y,y>, <x,y>, <x,x>]``; rows not
    requested by ``opts`` stay zero."""
    ddt = dot_acc_dtype(torch.promote_types(y2.dtype, x2.dtype))
    dots = torch.zeros((3, y2.shape[1]), dtype=ddt, device=y2.device)
    if opts.dot_yy:
        dots[0] = _acc_dot(y2, y2)
    if opts.dot_xy:
        dots[1] = _acc_dot(x2, y2)
    if opts.dot_xx:
        dots[2] = _acc_dot(x2, x2)
    return dots


def spmv_ref(
    A: SellCS,
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    opts: SpmvOpts = SpmvOpts(),
):
    """The plain PyTorch fused SpMV.  Returns ``(y, z, dots)``.

    ``dots`` is a ``(3, b)`` float64 tensor (rows yy, xy, xx; zeros where
    not requested) or None; ``z`` is None unless chaining was requested.
    """
    x2, was1d = as2d(x)
    n = A.nrows_pad
    square = x2.shape[0] == n
    if x2.shape[0] != x_rows(A):
        raise ValueError(
            f"spmv: x must be permuted/padded to {x_rows(A)} rows, "
            f"got {tuple(x2.shape)}")
    if (opts.gamma is not None or opts.dot_xy or opts.dot_xx) and not square:
        raise ValueError("gamma shift / x-dots need a square (diag-aligned) part")
    # a narrower store dtype upcasts per element before the products
    acc_dt = torch.promote_types(A.dtype, x2.dtype)
    contrib = A.vals.to(acc_dt)[:, None] * x2.to(acc_dt)[A.cols.long()]
    Ax = torch.zeros((n, x2.shape[1]), dtype=acc_dt, device=x2.device)
    Ax.index_add_(0, A.rowids.long(), contrib)

    if opts.gamma is not None:
        gamma = torch.as_tensor(opts.gamma, dtype=acc_dt, device=x2.device)
        Ax = Ax - gamma * x2                          # (A - gamma I) x
    ynew = opts.alpha * Ax
    if y is not None:
        y2, _ = as2d(y)
        ynew = ynew + opts.beta * y2.to(acc_dt)

    znew = None
    if opts.chain_axpby:
        if z is None:
            raise ValueError("spmv: chained axpby requires z")
        z2, _ = as2d(z)
        delta = 0.0 if opts.delta is None else opts.delta
        eta = 0.0 if opts.eta is None else opts.eta
        znew = delta * z2 + eta * ynew
        if was1d:
            znew = znew[:, 0]

    dots = fused_dots(x2, ynew, opts) if opts.any_dot else None

    if was1d:
        ynew = ynew[:, 0]
    return ynew, znew, dots


def spmv(
    A: SellCS,
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    opts: SpmvOpts = SpmvOpts(),
    *,
    impl: Optional[str] = None,
):
    """Dispatching fused SpMV (GHOST single-interface ``ghost_spmv``)."""
    if impl is None:
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return spmv_ref(A, x, y, z, opts)
    if impl == "cuda":
        from repro_torch.kernels import ops as kops
        return kops.sellcs_spmv(A, x, y, z, opts)
    raise ValueError(f"unknown impl {impl!r}")
