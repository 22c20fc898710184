"""Complex Hermitian test matrices for the port's complex parity tests.

A generator's symmetric COO triplets (nonpositive off-diagonals, as
``laplace3d`` and ``anisotropic_laplace2d`` have) with U(1) phases on
the off-diagonal entries: ``H_ij = L_ij exp(i theta_ij)`` with
``theta_ji = -theta_ij``, drawn from ``np.random.default_rng(seed)`` over
the upper triangle in COO order, and ``H_ii = L_ii``.  Then
``x^H H x >= |x|^T L |x|``, so ``lambda_min(H) >= lambda_min(L) > 0``
(Kato's inequality): H is Hermitian positive definite.  Both packages
receive the same numpy triplets.  ``chip_smoke.py:phased`` builds the
same values on the card.
"""
import numpy as np

from repro_torch.matrices import anisotropic_laplace2d, laplace3d


def phased(r, c, v, n: int, seed: int) -> np.ndarray:
    """The complex values of the phased matrix, in the COO order of
    ``(r, c, v)``."""
    r, c = np.asarray(r, np.int64), np.asarray(c, np.int64)
    up, lo = r < c, r > c
    theta_up = np.random.default_rng(seed).uniform(0.0, 2 * np.pi,
                                                   int(up.sum()))
    key = r[up] * n + c[up]
    order = np.argsort(key)
    want = c[lo] * n + r[lo]
    pos = order[np.minimum(np.searchsorted(key, want, sorter=order),
                           order.size - 1)]
    if not np.all(key[pos] == want):
        raise ValueError("phased: the pattern is not symmetric")
    theta = np.zeros(r.size)
    theta[up] = theta_up
    theta[lo] = -theta_up[pos]
    return np.asarray(v, np.float64) * np.exp(1j * theta)


def phased_laplace3d(nx: int, seed: int = 0):
    """``(rows, cols, complex values, n, real values)`` of the phased
    ``laplace3d(nx)``."""
    r, c, v, n = laplace3d(nx)
    return r, c, phased(r, c, v, n, seed), n, v


def phased_aniso(nx: int, epsilon: float = 1e-2, seed: int = 0):
    """The same for ``anisotropic_laplace2d(nx, epsilon)``."""
    r, c, v, n = anisotropic_laplace2d(nx, epsilon=epsilon)
    return r, c, phased(r, c, v, n, seed), n, v


def dense(r, c, v, n: int) -> np.ndarray:
    a = np.zeros((n, n), np.asarray(v).dtype)
    np.add.at(a, (np.asarray(r), np.asarray(c)), v)
    return a
