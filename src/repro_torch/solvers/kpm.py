"""Kernel Polynomial Method (paper section 1.3 / [24]).

KPM computes the spectral density (DOS) of a large sparse Hamiltonian from
Chebyshev moments mu_m = <v| T_m(As) |v> of the *scaled* operator
As = (A - gamma I) / a with spectrum in [-1, 1].

The Chebyshev recurrence

    w_{m+1} = 2 As w_m - w_{m-1} = (2/a) (A - gamma I) w_m - w_{m-1}

is exactly the fused augmented SpMV ``y = alpha (A - gamma I) x + beta y``
with alpha = 2/a, beta = -1, and the two moments per sweep come from the
fused dots <y, y> (-> mu_{2m+2}) and <x, y> (-> mu_{2m+1}): one launch of
kernel B1 per sweep on the card.  R Rademacher probe vectors ride one
block vector (SpMMV).

The probes are float32, as in the JAX package, so the operator computes
in float32; they come from a ``torch.Generator`` seeded with ``seed`` on
the operator's device, not from ``jax.random``.

The probes live on the operator's real rows only: they are drawn over
the matrix's ``nrows`` original rows, scaled by 1/sqrt(nrows) and placed
in the operator space with ``to_op_space``, so the padding slots (which
the operators keep at zero) hold zeros.  The moments then do not depend
on how the matrix is padded.  The JAX package draws over all ``op.n``
padded rows, so on a matrix whose row count is no multiple of C its
moments carry eigenvalue-0 terms from the padding (a deliberate
difference).

For a complex Hermitian operator every dot is conjugate-linear in its
first argument and each moment, real in exact arithmetic, enters the
float32 buffer as its real part.  The JAX package's mu_2 and unfused dots
do not conjugate (another deliberate difference); for real values the two
forms are the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.spmv import SpmvOpts
from repro_torch.solvers.lanczos import lanczos_extrema, op_device, real_rows

__all__ = ["kpm_dos_moments", "moment_step", "jackson_kernel", "kpm_dos"]


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-column <u, v>, conjugate-linear in ``u`` (a plain sum for
    real values)."""
    return torch.sum(torch.conj(u) * v, 0)


def _re(t: torch.Tensor) -> torch.Tensor:
    return t.real if t.is_complex() else t


def moment_step(op, w0, w1, alpha2: float, gamma: float, mu0, mu1):
    """One fused sweep of the recurrence: ``w2 = alpha2 (A - gamma I) w1 -
    w0`` and the moments ``mu_{2m+1} = 2 <w1, w2> - mu_1`` and ``mu_{2m+2}
    = 2 <w2, w2> - mu_0`` from its dots, one B1 launch on the card and no
    host sync.  Returns ``(w2, mu_{2m+1}, mu_{2m+2})``."""
    w2, _, dots = op.mv_fused(
        w1, y=w0, opts=SpmvOpts(alpha=alpha2, beta=-1.0, gamma=gamma,
                                dot_yy=True, dot_xy=True))
    return (w2, 2.0 * _re(dots[1]).to(mu1.dtype) - mu1,
            2.0 * _re(dots[0]).to(mu0.dtype) - mu0)


def kpm_dos_moments(op, n_moments: int, *, n_probes: int = 4,
                    spectrum: Optional[Tuple[float, float]] = None,
                    seed: int = 0, fused: bool = True) -> torch.Tensor:
    """Stochastic Chebyshev moments mu_0..mu_{M-1} (averaged over probes).

    ``fused=True`` uses the augmented SpMV (two moments per sweep);
    ``fused=False`` runs the naive variant (SpMV, then separate vector
    updates and dots).
    """
    lo, hi = lanczos_extrema(op) if spectrum is None else spectrum
    a = (hi - lo) / 2.0
    gamma = (hi + lo) / 2.0
    alpha2 = 2.0 / a

    dev = op_device(op)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    # Rademacher probes on the real rows, zero in the padding slots
    n, place = real_rows(op)
    bits = torch.rand((n, n_probes), generator=g, device=dev) < 0.5
    v0 = place(torch.where(bits, 1.0, -1.0).to(torch.float32) / np.sqrt(n))

    M = n_moments
    half = (M + 1) // 2
    mus = torch.zeros((M + 2, n_probes), dtype=torch.float32, device=dev)

    # w0 = v, w1 = As v  (alpha = 1/a for the first application)
    w0 = v0
    w1, _, d = op.mv_fused(
        w0, opts=SpmvOpts(alpha=1.0 / a, gamma=gamma, dot_xx=True,
                          dot_xy=True))
    # the dots accumulate in float64 (complex128 for a complex operator,
    # whose moments are real: <v, T_k(As) v> with As Hermitian); the real
    # part goes into the moment dtype
    mus[0] = _re(d[2]).to(mus.dtype)                         # <v,v>
    mus[1] = _re(d[1]).to(mus.dtype)                         # <v, As v>
    mu0, mu1 = mus[0].clone(), mus[1].clone()
    w1_first = w1

    odds, evens = [], []
    for _ in range(half):
        if fused:
            w2, odd, even = moment_step(op, w0, w1, alpha2, gamma, mu0, mu1)
            odds.append(odd)
            evens.append(even)
        else:
            Aw = op.mv(w1)
            w2 = alpha2 * (Aw - gamma * w1) - w0
            odds.append(2.0 * _re(_dot(w1, w2)).to(mu1.dtype) - mu1)
            evens.append(2.0 * _re(_dot(w2, w2)).to(mu0.dtype) - mu0)
        w0, w1 = w1, w2

    # mu_2 = 2<w1,w1> - mu_0; step m = 1..half gives mu_{2m+1}, mu_{2m+2}
    # (indices past the buffer are dropped, as JAX's scatter drops them)
    mus[2] = (2.0 * _re(_dot(w1_first, w1_first)).to(mus.dtype)
              - mus[0])
    for m in range(half):
        for idx, val in ((2 * m + 3, odds[m]), (2 * m + 4, evens[m])):
            if idx < M + 2:
                mus[idx] = val
    return torch.mean(mus[:M], dim=1)


def jackson_kernel(M: int) -> np.ndarray:
    """Jackson damping factors g_m (standard KPM smoothing)."""
    m = np.arange(M)
    return ((M - m + 1) * np.cos(np.pi * m / (M + 1))
            + np.sin(np.pi * m / (M + 1)) / np.tan(np.pi / (M + 1))) / (M + 1)


def kpm_dos(op, n_moments: int = 64, n_bins: int = 128, **kw):
    """Reconstruct the DOS on a grid from damped moments."""
    if kw.get("spectrum") is not None:
        lo, hi = kw["spectrum"]
    else:
        lo, hi = lanczos_extrema(op)
        kw["spectrum"] = (lo, hi)
    mus = kpm_dos_moments(op, n_moments, **kw).double().cpu().numpy()
    g = jackson_kernel(n_moments)
    xg = np.linspace(-0.999, 0.999, n_bins)
    tm = np.cos(np.arange(n_moments)[:, None] * np.arccos(xg)[None, :])
    mu0 = mus[0] if mus[0] != 0 else 1.0
    rho = (mus[0] * tm[0] + 2 * (g[1:, None] * mus[1:, None] * tm[1:]).sum(0))
    rho /= (np.pi * np.sqrt(1 - xg**2)) * mu0
    a = (hi - lo) / 2
    energies = xg * a + (hi + lo) / 2
    return energies, rho / a          # Jacobian: rho(E) dE = rho(x) dx
