"""Chebyshev filter diagonalization (paper section 1.3 / [38]).

Computes eigenpairs inside a target interval [lo_t, hi_t] of a symmetric
operator by repeatedly applying a Chebyshev polynomial filter to a block
of vectors (fused SpMMV, kernel B1) followed by Rayleigh-Ritz, whose Gram
matrices and basis updates all go through the tall-skinny kernels
(:func:`repro_torch.kernels.ops.tsmttsm` / ``tsmm``, kernels B2 and B3).
The JAX package's ``use_pallas_tsm`` switch has no counterpart: the port
always takes the kernel wrappers (the plain versions for CPU tensors).

For a complex Hermitian operator the orthonormalisation and Rayleigh-Ritz
take conjugate transposes and the residuals |R|^2, so the Ritz values are
real; the JAX package transposes without the conjugate
(``repro/solvers/chebfd.py``), a deliberate difference.  For real values
the two forms are the same.  The port also orthonormalises each filtered
block twice, with its columns scaled first (``_orthonormalize``), where
the JAX package makes one Cholesky QR pass.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.spmv import SpmvOpts
from repro_torch.kernels import ops
from repro_torch.solvers.lanczos import (lanczos_extrema, op_device, randn,
                                         real_rows)

__all__ = ["ChebFDResult", "chebfd"]


class ChebFDResult(NamedTuple):
    eigenvalues: np.ndarray
    eigenvectors: torch.Tensor
    residuals: np.ndarray
    sweeps: int


def _cheb_filter(op, V, degree: int, a: float, gamma: float,
                 lo_t: float, hi_t: float):
    """Apply the [lo_t, hi_t]-bandpass Chebyshev filter of given degree to
    block V via the fused augmented SpMV recurrence."""
    # filter coefficients of the ideal bandpass on the scaled spectrum
    tl = (lo_t - gamma) / a
    tu = (hi_t - gamma) / a
    m = np.arange(degree + 1)
    with np.errstate(invalid="ignore"):
        coef = (np.arccos(np.clip(tl, -1, 1))
                - np.arccos(np.clip(tu, -1, 1))) / np.pi
        coef = np.where(
            m == 0, coef,
            2.0 / np.pi / np.maximum(m, 1)
            * (np.sin(m * np.arccos(np.clip(tl, -1, 1)))
               - np.sin(m * np.arccos(np.clip(tu, -1, 1)))))
    coef = [float(c) for c in coef * _jackson(degree + 1)]

    w0 = V
    w1, _, _ = op.mv_fused(w0, opts=SpmvOpts(alpha=1.0 / a, gamma=gamma))
    acc = coef[0] * w0 + coef[1] * w1
    for k in range(2, degree + 1):
        w2, _, _ = op.mv_fused(
            w1, y=w0, opts=SpmvOpts(alpha=2.0 / a, beta=-1.0, gamma=gamma))
        acc = acc + coef[k] * w2
        w0, w1 = w1, w2
    return acc


def _jackson(M: int) -> np.ndarray:
    m = np.arange(M)
    return ((M - m + 1) * np.cos(np.pi * m / (M + 1))
            + np.sin(np.pi * m / (M + 1)) / np.tan(np.pi / (M + 1))) / (M + 1)


def _orthonormalize(V):
    """An orthonormal basis of V's span: Cholesky QR of the tall-skinny
    Gram matrix, with the columns scaled to unit norm first, done twice
    (CholQR2).  A filtered block's columns differ in norm by many orders
    and are nearly dependent; one pass, as the JAX package makes, leaves
    them far from orthonormal at large degrees (Ritz values below the
    spectrum on the phased laplace3d(160) at degree 200), the second
    pass restores orthonormality to rounding."""
    for _ in range(2):
        G = ops.tsmttsm(V, V)                    # (b, b)
        d = torch.diagonal(G)
        d = d.real if d.is_complex() else d
        s = (torch.where(d > 0, d, 1.0) ** -0.5).to(G.dtype)
        eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
        L = torch.linalg.cholesky(s[:, None] * G * s[None, :] + 1e-12 * eye)
        V = ops.tsmm(V, (s[:, None] * torch.linalg.inv(L).mH).to(V.dtype))
    return V


def chebfd(op, target: Tuple[float, float], block_size: int = 8, *,
           degree: int = 60, sweeps: int = 4, seed: int = 0,
           spectrum: Optional[Tuple[float, float]] = None) -> ChebFDResult:
    """Find eigenpairs in ``target`` = (lo_t, hi_t).  The start block is
    :func:`repro_torch.solvers.lanczos.randn` on the operator's device,
    over the matrix's real rows and placed in the operator space (the JAX
    package draws over all padded rows, a deliberate difference, as for
    KPM's probes)."""
    lo, hi = lanczos_extrema(op) if spectrum is None else spectrum
    a = (hi - lo) / 2.0
    gamma = (hi + lo) / 2.0

    # the start block lives on the real rows (zero in the padding slots,
    # which the operators keep at zero): a padding slot is an eigenvector
    # of eigenvalue 0, which the filter would amplify without bound where
    # 0 lies outside ``spectrum``
    n, place = real_rows(op)
    V = place(randn(seed, (n, block_size), op.dtype, op_device(op)))
    for _ in range(sweeps):
        V = _orthonormalize(_cheb_filter(op, V, degree, a, gamma, *target))
        # Rayleigh-Ritz
        H = ops.tsmttsm(V, op.mv(V))             # (b, b) projected operator
        _, Q = torch.linalg.eigh((H + H.mH) / 2)
        V = ops.tsmm(V, Q.to(V.dtype))

    AV = op.mv(V)
    w = torch.diagonal(ops.tsmttsm(V, AV))
    w = w.real if w.is_complex() else w          # Hermitian: real Ritz values
    R = AV - V * w[None, :]
    res = torch.sqrt(torch.sum((torch.conj(R) * R).real, dim=0))
    w_h = w.cpu().numpy()
    order = np.argsort(w_h)
    return ChebFDResult(w_h[order], V[:, torch.as_tensor(order,
                                                       device=V.device)],
                        res.cpu().numpy()[order], sweeps)
