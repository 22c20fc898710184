"""Block vectors — tall & skinny dense matrices (paper C2), in PyTorch.

A block vector is ``(n, b)`` with small ``b`` in row-major interleaved
storage (the columns of one row sit together).  The paper's column-major
variant is represented as ``(b, n)`` and exists for the layout study; all
compute prefers row-major.

The plain versions of GHOST's tall-skinny kernels and blocked BLAS-1:

    tsmttsm : X = alpha * V^H W + beta * X      (inner product of blocks)
    tsmm    : W = alpha * V X + beta * W        (block times small matrix)
    tsmm_inplace
    axpy / axpby / scal / dot  (+ v-variants with per-column scalars)
    Kahan-compensated tsmttsm and dot (paper section 5.2)

They run on any device; the hand-written CUDA kernels for the two GEMMs
are reached through :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.spmv import storage_acc_dtype

__all__ = [
    "tsmttsm", "tsmm", "tsmm_inplace", "axpy", "axpby", "scal", "dot",
    "vaxpy", "vaxpby", "vscal", "tsmttsm_kahan", "dot_kahan",
    "view_cols", "compact_clone", "to_col_major", "to_row_major",
    "check_beta_needs_out", "acc_dtype",
]


# ----------------------------------------------------------------- views
def view_cols(v: torch.Tensor, cols: Sequence[int]) -> torch.Tensor:
    """A (possibly scattered) selection of block-vector columns."""
    return v[:, torch.as_tensor(list(cols), dtype=torch.long,
                                device=v.device)]


def compact_clone(v: torch.Tensor) -> torch.Tensor:
    """A compact copy (paper: clone a scattered view before compute)."""
    return v.clone(memory_format=torch.contiguous_format)


def to_col_major(v: torch.Tensor) -> torch.Tensor:
    return v.T


def to_row_major(v: torch.Tensor) -> torch.Tensor:
    return v.T


def check_beta_needs_out(beta, out, fn: str) -> None:
    """A nonzero ``beta`` without the output operand would silently drop
    the ``beta * out`` term: raise instead.  ``beta`` is a number or a 0-d
    tensor (a tensor on the card is read back to decide)."""
    if out is not None:
        return
    if bool(torch.as_tensor(beta) != 0):
        raise ValueError(
            f"{fn}: beta != 0 without the output operand — the beta term "
            f"would be silently dropped; pass the output block or leave "
            f"beta=0")


def acc_dtype(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """Accumulation dtype of a product of ``a`` and ``b`` operands:
    float32 for bfloat16/float16, otherwise the promoted type."""
    return storage_acc_dtype(torch.promote_types(a, b))


# ------------------------------------------------------- tall-skinny GEMMs
def tsmttsm(V: torch.Tensor, W: torch.Tensor,
            X: Optional[torch.Tensor] = None, alpha=1.0, beta=0.0, *,
            conj: bool = True) -> torch.Tensor:
    """X = alpha * V^H W + beta * X, accumulated at :func:`acc_dtype`.

    V: (n, m), W: (n, k) -> (m, k) in the accumulation dtype (as the JAX
    package's ``blockvec.tsmttsm``).
    """
    check_beta_needs_out(beta, X, "tsmttsm")
    acc = acc_dtype(V.dtype, W.dtype)
    Vh = V.to(acc)
    if conj and Vh.is_complex():
        Vh = Vh.conj()
    out = alpha * (Vh.T @ W.to(acc))
    if X is not None:
        out = out + beta * X.to(out.dtype)
    return out


def tsmm(V: torch.Tensor, X: torch.Tensor, W: Optional[torch.Tensor] = None,
         alpha=1.0, beta=0.0) -> torch.Tensor:
    """W = alpha * V X + beta * W.   V: (n, m), X: (m, k) -> (n, k) in
    ``promote_types(V, X)``, accumulated at :func:`acc_dtype`."""
    check_beta_needs_out(beta, W, "tsmm")
    acc = acc_dtype(V.dtype, X.dtype)
    out = alpha * (V.to(acc) @ X.to(acc))
    if W is not None:
        out = out + beta * W.to(out.dtype)
    return out.to(torch.promote_types(V.dtype, X.dtype))


def tsmm_inplace(V: torch.Tensor, X: torch.Tensor, alpha=1.0,
                 beta=0.0) -> torch.Tensor:
    """V X alpha + beta V, returned as a new tensor (V is not written)."""
    return tsmm(V, X, V, alpha=alpha, beta=beta)


# ---------------------------------------------------------------- BLAS-1(.5)
def axpy(y, x, a=1.0):
    return y + a * x


def axpby(y, x, a=1.0, b=1.0):
    return b * y + a * x


def scal(x, a):
    return a * x


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Column-wise <x, y> (conjugated first argument)."""
    xc = x.conj() if x.is_complex() else x
    return torch.sum(xc * y, dim=0)


def _col(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)[None, :]


def vaxpy(y, x, a):
    """Per-column scalars a: (b,)."""
    return y + _col(a, y) * x


def vaxpby(y, x, a, b):
    return _col(b, y) * y + _col(a, y) * x


def vscal(x, a):
    return _col(a, x) * x


# -------------------------------------------------------------------- Kahan
def _kahan_reduce(terms: torch.Tensor) -> torch.Tensor:
    """Compensated (Kahan) summation over axis 0, in order."""
    s = torch.zeros(terms.shape[1:], dtype=terms.dtype, device=terms.device)
    c = torch.zeros_like(s)
    for t in terms:
        yk = t - c
        tk = s + yk
        c = (tk - s) - yk
        s = tk
    return s


def _row_blocks(t: torch.Tensor, block: int) -> torch.Tensor:
    """``t`` (n, ...) zero-padded to whole ``block``-row blocks, as
    ``(nblocks, block, ...)`` (at least one block)."""
    n = t.shape[0]
    nb = max(1, -(-n // block))
    pad = nb * block - n
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    return t.reshape(nb, block, *t.shape[1:])


def dot_kahan(x: torch.Tensor, y: torch.Tensor, *,
              block: int = 256) -> torch.Tensor:
    """Kahan-compensated column-wise dot: blocks of ``block`` rows summed
    plainly, the block partials combined with Kahan compensation."""
    xc = x.conj() if x.is_complex() else x
    return _kahan_reduce(_row_blocks(xc * y, block).sum(dim=1))


def tsmttsm_kahan(V: torch.Tensor, W: torch.Tensor, *,
                  block: int = 256) -> torch.Tensor:
    """Kahan-compensated V^H W (the paper's compensated inner product):
    per-``block`` partial products, Kahan-summed over the blocks."""
    acc = acc_dtype(V.dtype, W.dtype)
    Vh = V.to(acc)
    if Vh.is_complex():
        Vh = Vh.conj()
    partials = torch.einsum("zbm,zbk->zmk", _row_blocks(Vh, block),
                            _row_blocks(W.to(acc), block))
    return _kahan_reduce(partials)
