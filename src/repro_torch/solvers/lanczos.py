"""Lanczos tridiagonalization and extremal eigenvalue estimation.

A GHOST sample application and the engine behind the spectral-interval
estimate that KPM and Chebyshev filter diagonalization need.  Each step
is one SpMV (kernel B1 on the card) plus vector arithmetic; the small
tridiagonal is diagonalised on the host with scipy, as in the JAX package.

Start vectors drawn here come from a ``torch.Generator`` seeded with
``seed`` on the operator's device; they are not the JAX package's
``jax.random`` numbers, so a comparison between the two packages passes
``v0`` explicitly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.execution import resolve_device

__all__ = ["LanczosResult", "randn", "lanczos", "tridiag_eigh",
           "lanczos_extrema", "op_device", "real_rows"]


class LanczosResult(NamedTuple):
    alphas: torch.Tensor            # (k,)   entries past nvalid are zero
    betas: torch.Tensor             # (k-1,) entries past nvalid-1 are zero
    V: Optional[torch.Tensor]       # (n, k) basis if kept (zero past nvalid)
    nvalid: Optional[torch.Tensor] = None   # () valid Lanczos steps (< k
    #                                         after a happy breakdown)


def op_device(op) -> torch.device:
    """The device an operator's vectors live on (``None``: the card)."""
    return resolve_device(getattr(op, "device", None))


def real_rows(op):
    """``(n, place)``: the operator's number of real rows and the map of
    a vector over them into the operator space (``to_op_space`` for an
    operator over a matrix, which zeros the padding; the identity for a
    matrix-free operator, all of whose ``n`` rows are real)."""
    A = getattr(op, "A", None)
    if A is None or not hasattr(op, "to_op_space"):
        return op.n, lambda v: v
    return A.nrows, op.to_op_space


def randn(seed: int, shape, dtype: torch.dtype, device=None) -> torch.Tensor:
    """Gaussian start block in ``dtype`` (complex-aware), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    if dtype.is_complex:
        rdt = torch.empty((), dtype=dtype).real.dtype
        re = torch.randn(shape, generator=g, dtype=rdt, device=dev)
        im = torch.randn(shape, generator=g, dtype=rdt, device=dev)
        return torch.complex(re, im)
    return torch.randn(shape, generator=g, dtype=dtype, device=dev)


def lanczos(op, v0: Optional[torch.Tensor], k: int, *, reorth: bool = False,
            keep_basis: bool = False, seed: int = 0) -> LanczosResult:
    """k-step Lanczos on a symmetric/Hermitian op.  ``v0`` (n,) start, or
    None for a :func:`randn` start on the operator's device.

    Breakdown: once a step's beta is 0 the Krylov space is exhausted
    (happy breakdown).  The loop keeps its k steps but masks the frozen
    ones — they write nothing — and ``nvalid`` reports the usable prefix,
    so the recurrence never waits on the host.
    """
    n = op.n
    if v0 is None:
        v0 = randn(seed, (n,), op.dtype, op_device(op))
    v = v0 / torch.linalg.norm(v0)
    dev = v.device
    rdt = torch.empty((), dtype=v.dtype).real.dtype
    alphas = torch.zeros(k, dtype=rdt, device=dev)
    betas = torch.zeros(max(k - 1, 1), dtype=rdt, device=dev)
    V = (torch.zeros((n, k), dtype=v.dtype, device=dev)
         if (keep_basis or reorth) else None)

    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=rdt, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)
    nvalid = torch.zeros((), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=rdt, device=dev)
    for j in range(k):
        if V is not None:
            V[:, j] = torch.where(alive, v, torch.zeros_like(v))
        w = op.mv(v[:, None])[:, 0]
        alpha = torch.vdot(v, w)
        w = w - alpha * v - beta * v_prev
        if V is not None and reorth:
            # conjugate transpose: for complex Hermitian operators the
            # projector is V V^H, not V V^T
            w = w - V @ (V.conj().T @ w)
        alphas[j] = torch.where(alive, alpha.real, zero)
        nvalid = nvalid + alive.to(torch.int32)
        beta_new = torch.linalg.norm(w).to(rdt)
        step_alive = alive & (beta_new > 0)
        if j < k - 1:
            betas[j] = torch.where(step_alive, beta_new, zero)
        v_prev = v
        v = torch.where(step_alive,
                        w / torch.where(beta_new == 0, 1.0, beta_new), v)
        beta = torch.where(step_alive, beta_new, zero)
        alive = step_alive
    return LanczosResult(alphas, betas[: max(k - 1, 0)], V, nvalid)


def tridiag_eigh(alphas, betas) -> Tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition of the Lanczos tridiagonal (host-side, scipy)."""
    from scipy.linalg import eigh_tridiagonal
    return eigh_tridiagonal(_host(alphas), _host(betas))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def lanczos_extrema(op, *, k: int = 30, seed: int = 0,
                    safety: float = 1.05) -> Tuple[float, float]:
    """Estimate (lambda_min, lambda_max) with a short Lanczos run, widened
    by ``safety`` — the spectral scaling KPM/ChebFD need.  Only the valid
    prefix of the recurrence enters the tridiagonal."""
    res = lanczos(op, None, k, seed=seed)
    nv = max(int(res.nvalid), 1)
    ev, _ = tridiag_eigh(_host(res.alphas)[:nv],
                         _host(res.betas)[:max(nv - 1, 0)])
    lo, hi = float(ev[0]), float(ev[-1])
    mid, rad = (hi + lo) / 2, (hi - lo) / 2
    rad = max(rad * safety, 1e-12)
    return mid - rad, mid + rad
