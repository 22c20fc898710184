"""Preconditioners on the GHOST building blocks (block-Jacobi + Chebyshev).

The port of ``repro.solvers.precond``.  Both preconditioners expose
``apply(r)`` on ``(n,)``/``(n, b)`` vectors in the operator's (permuted)
space — the protocol ``cg``/``minres`` expect from their ``M=`` argument —
and are fixed linear SPD operators, so PCG / preconditioned MINRES theory
applies.

* :class:`BlockJacobiPreconditioner` — the aligned diagonal blocks are
  extracted from the SELL-C-sigma arrays in permuted space, inverted on
  the host once in float64 (Cholesky, with an LU / pseudo-inverse
  fallback for indefinite or singular blocks), moved to the matrix'
  device in its compute dtype, and applied by the batched block-diagonal
  kernel (``kernels/ops.py:block_jacobi_apply``, kernel B4).
* :class:`ChebyshevPreconditioner` — a fixed-degree Chebyshev polynomial in
  the operator over a spectral interval the caller supplies (the port has
  no matrix registry yet: take it from :func:`lanczos_extrema`), applied
  as a short recurrence of fused SpMVs (``op.mv_fused`` with ``alpha=-1,
  beta=1``, kernel B1).

Build them with :func:`make_preconditioner` from a spec string.
"""
from __future__ import annotations

import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sellcs import SellCS
from repro_torch.core.spmv import SpmvOpts, as2d
from repro_torch.kernels import ops

__all__ = [
    "BlockJacobiPreconditioner", "ChebyshevPreconditioner",
    "extract_block_diag", "factorize_blocks", "make_preconditioner",
    "parse_precond_spec",
]


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 (which numpy lacks) widens
    exactly to float64."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float64)
    return t.numpy()


# ------------------------------------------------------- block extraction
def extract_block_diag(A: SellCS, block_size: int) -> np.ndarray:
    """Aligned diagonal blocks of ``A`` in **permuted** space (host-side).

    Returns ``(nrows_pad // block_size, block_size, block_size)`` dense
    float64 (complex128 for complex values) blocks of the row/column-
    permuted matrix ``P A P^T`` — the matrix the solvers iterate on.  The
    extraction reads the SELL-C-sigma arrays: ``rowids`` are sorted-space
    rows, and ``cols`` are sorted-space columns when ``permuted_cols`` is
    set (otherwise they are mapped through ``iperm`` here).  Slot validity
    comes from the construction-recorded row lengths, so explicitly stored
    zeros keep their slot.

    ``block_size`` must divide ``nrows_pad``; a divisor of ``C`` keeps
    blocks inside chunks (the "aligned" in aligned blocks).
    """
    if A.nrows != A.ncols:
        raise ValueError(
            f"block-Jacobi needs a square matrix, got {A.shape}")
    bs = int(block_size)
    if bs <= 0 or A.nrows_pad % bs != 0:
        raise ValueError(
            f"block_size ({bs}) must divide nrows_pad ({A.nrows_pad}); "
            f"divisors of C={A.C} are the aligned choices")
    mask = A.valid_slots()
    rows = _host(A.rowids).astype(np.int64)[mask]        # permuted space
    cols = _host(A.cols).astype(np.int64)[mask]
    vals = _host(A.vals)[mask]
    wdt = np.complex128 if np.iscomplexobj(vals) else np.float64
    vals = vals.astype(wdt)
    if not A.permuted_cols:
        cols = _host(A.iperm).astype(np.int64)[cols]      # -> permuted space
    nb = A.nrows_pad // bs
    blocks = np.zeros((nb, bs, bs), wdt)
    same = (rows // bs) == (cols // bs)
    np.add.at(blocks, (rows[same] // bs, rows[same] % bs, cols[same] % bs),
              vals[same])
    return blocks


def factorize_blocks(blocks: np.ndarray, *,
                     absolute: bool = False) -> np.ndarray:
    """Invert the diagonal blocks on the host, once (the set-up phase).

    Structurally empty rows (e.g. the padding rows above ``nrows``) get a
    unit diagonal, so the preconditioner acts as the identity there.  SPD
    blocks go through Cholesky; indefinite ones fall back to LU, singular
    ones to the pseudo-inverse.  ``absolute=True`` inverts ``|B_k|``
    instead (symmetrize, eigendecompose, flip negative eigenvalues), which
    stays SPD over an indefinite matrix, as preconditioned MINRES needs.
    Complex blocks stay complex (Hermitian Cholesky / eigh).
    """
    blocks = np.asarray(blocks)
    wdt = np.complex128 if np.iscomplexobj(blocks) else np.float64
    blocks = blocks.astype(wdt)
    nb, bs, _ = blocks.shape
    empty = (np.abs(blocks).sum(axis=2) == 0)            # (nb, bs) zero rows
    if empty.any():
        kb, kr = np.nonzero(empty)
        blocks[kb, kr, kr] = 1.0
    if absolute:
        herm = (blocks + blocks.conj().transpose(0, 2, 1)) / 2.0
        w, Q = np.linalg.eigh(herm)                      # batched; w real
        wmax = np.abs(w).max(axis=1, keepdims=True)
        w = np.maximum(np.abs(w), 1e-12 * np.maximum(wmax, 1.0))
        return np.einsum("kij,kj,klj->kil", Q, 1.0 / w, Q.conj())

    def _chol_inv(stack):
        ch = np.linalg.cholesky(stack)                   # batched HPD
        ident = np.broadcast_to(np.eye(bs, dtype=wdt), stack.shape)
        half = np.linalg.solve(ch, ident)
        return half.conj().transpose(0, 2, 1) @ half     # (L L^H)^-1

    try:
        return _chol_inv(blocks)             # one batched call, common case
    except np.linalg.LinAlgError:
        pass                                 # some block not HPD: per-block
    inv = np.empty_like(blocks)
    for k in range(nb):
        blk = blocks[k]
        try:
            inv[k] = _chol_inv(blk[None])[0]
        except np.linalg.LinAlgError:
            try:
                inv[k] = np.linalg.inv(blk)
            except np.linalg.LinAlgError:
                inv[k] = np.linalg.pinv(blk)
    return inv


class BlockJacobiPreconditioner:
    """``M = diag(B_0, ..., B_{k-1})^{-1}`` over aligned permuted-space blocks.

    The inverse blocks live on the matrix' device in its compute dtype;
    ``apply`` is one launch of the block-diagonal kernel (B4) on the card,
    its plain version on the CPU.
    """

    def __init__(self, A: SellCS, block_size: Optional[int] = None, *,
                 absolute: bool = False):
        if not isinstance(A, SellCS):
            raise TypeError(
                "block-Jacobi extracts blocks from SELL-C-sigma storage; "
                f"got {type(A).__name__}.  Matrix-free operators should use "
                "the Chebyshev preconditioner, which only needs the "
                "operator's matvec.")
        bs = int(block_size) if block_size is not None else int(A.C)
        self.A = A
        self.block_size = bs
        self.absolute = bool(absolute)
        self.dtype = A.dtype
        self.n = A.nrows_pad
        # extraction and factorization run in float64/complex128 on the
        # host, so a narrow store_dtype never degrades the inverse; the
        # inverses land in the *compute* dtype
        inv = factorize_blocks(extract_block_diag(A, bs), absolute=absolute)
        self.inv_blocks = torch.from_numpy(inv).to(device=A.device,
                                                   dtype=self.dtype)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """``z = M r`` for ``(n,)`` or ``(n, b)`` permuted-space vectors."""
        return ops.block_jacobi_apply(self.inv_blocks, r)

    def __repr__(self) -> str:
        return (f"BlockJacobiPreconditioner(n={self.n}, "
                f"bs={self.block_size}, dtype={self.dtype})")


# ------------------------------------------------------------- Chebyshev
class ChebyshevPreconditioner:
    """Fixed-degree Chebyshev polynomial preconditioner ``M ~ A^{-1}``.

    ``degree`` steps of the Chebyshev iteration for ``A y = r`` from
    ``y0 = 0`` (Saad, *Iterative Methods*, Alg. 12.1) over ``[lo, hi]``:
    a fixed polynomial ``y = p(A) r``, positive on the interval, hence a
    linear SPD operator whenever ``A`` is SPD.  Each apply costs
    ``degree - 1`` fused SpMVs (``r_k = r_{k-1} - A d_k`` as one
    ``alpha=-1, beta=1`` sweep).

    A non-positive ``lo`` (a widened Lanczos bracket of an ill-conditioned
    SPD matrix can dip below zero) is clamped to ``hi / min_ratio``.

    The operator is held through a **weak** reference, as in the JAX
    package; keep it alive for as long as the preconditioner is used.
    """

    def __init__(self, op, spectrum: Tuple[float, float], degree: int = 4,
                 *, min_ratio: float = 30.0):
        lo, hi = float(spectrum[0]), float(spectrum[1])
        if hi <= 0.0:
            raise ValueError(
                f"Chebyshev preconditioning needs an SPD operator "
                f"(lambda_max > 0), got bounds ({lo:g}, {hi:g})")
        lo = max(lo, hi / float(min_ratio))
        if degree < 1:
            raise ValueError(f"degree must be >= 1, got {degree}")
        self._op_ref = weakref.ref(op)
        self.lo, self.hi = lo, hi
        self.degree = int(degree)
        self.dtype = op.dtype
        self.n = op.n

    @property
    def op(self):
        o = self._op_ref()
        if o is None:
            raise ReferenceError(
                "the operator behind this ChebyshevPreconditioner has "
                "been garbage-collected; rebuild the preconditioner")
        return o

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        r2, was1d = as2d(r)
        theta = (self.hi + self.lo) / 2.0
        delta = (self.hi - self.lo) / 2.0
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        d = r2 / theta
        y = d
        resid = None
        fuse = SpmvOpts(alpha=-1.0, beta=1.0)
        if self.degree > 1:
            resid, _, _ = self.op.mv_fused(y, y=r2, opts=fuse)  # r - A y
        for k in range(1, self.degree):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * resid
            y = y + d
            if k < self.degree - 1:
                resid, _, _ = self.op.mv_fused(d, y=resid, opts=fuse)
            rho = rho_new
        return y[:, 0] if was1d else y

    def __repr__(self) -> str:
        return (f"ChebyshevPreconditioner(degree={self.degree}, "
                f"interval=({self.lo:g}, {self.hi:g}))")


# ------------------------------------------------------------ spec parsing
def parse_precond_spec(spec: str) -> Tuple[str, Optional[int]]:
    """Normalize a preconditioner spec string.

    ``"block_jacobi"`` / ``"block_jacobi:<bs>"`` (``block_jacobi_abs`` for
    the SPD absolute-value variant over indefinite matrices) /
    ``"chebyshev"`` / ``"chebyshev:<degree>"`` -> ``(kind, param or
    None)``.  Raises on anything else.  ``"chebyshev"`` normalizes to
    degree 4; the block-Jacobi default stays ``None`` (the matrix' ``C``).
    """
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"preconditioner spec must be a non-empty string, "
                         f"got {spec!r}")
    kind, _, arg = spec.partition(":")
    if kind not in ("block_jacobi", "block_jacobi_abs", "chebyshev"):
        raise ValueError(
            f"unknown preconditioner {kind!r} "
            f"(have: block_jacobi[:<block_size>], "
            f"block_jacobi_abs[:<block_size>], chebyshev[:<degree>])")
    if not arg:
        return kind, (4 if kind == "chebyshev" else None)
    try:
        val = int(arg)
    except ValueError:
        raise ValueError(
            f"preconditioner parameter must be an integer, got {arg!r} "
            f"in {spec!r}") from None
    if val <= 0:
        raise ValueError(f"preconditioner parameter must be positive "
                         f"({spec!r})")
    return kind, val


def make_preconditioner(spec: str, *, matrix=None, op=None,
                        spectrum: Optional[Tuple[float, float]] = None):
    """Build a preconditioner from a spec string.

    ``block_jacobi`` needs ``matrix`` (a :class:`SellCS`); ``chebyshev``
    needs ``op`` and ``spectrum`` (for example from
    :func:`repro_torch.solvers.lanczos_extrema`).
    """
    kind, param = parse_precond_spec(spec)
    if kind in ("block_jacobi", "block_jacobi_abs"):
        return BlockJacobiPreconditioner(matrix, block_size=param,
                                         absolute=kind.endswith("_abs"))
    if op is None or spectrum is None:
        raise ValueError("chebyshev preconditioner needs op= and spectrum=")
    return ChebyshevPreconditioner(op, spectrum,
                                   degree=param if param else 4)
