"""Sparse test-matrix generators (host-side COO).

A numpy-only copy of ``repro.matrices.generators``: the port builds its
matrices without importing the JAX package, and the parity tests hold
every generator's COO triplets identical to the reference's.

Mirrors the paper's application domains: MATPDE (section 6.1 case study),
quantum Hamiltonians from the ESSEX project (Anderson disorder, graphene
tight-binding, spin chains — sections 1.1/1.3), plus generic banded/Laplace
operators standing in for the SuiteSparse test cases (ML_Geer, cage15,
3Dspectralwave) that cannot be shipped offline.

All generators return ``(rows, cols, vals, n)`` numpy COO.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "matpde", "anderson3d", "graphene", "laplace2d", "laplace3d",
    "anisotropic_laplace2d", "banded_random", "spin_chain_xx",
]

Coo = Tuple[np.ndarray, np.ndarray, np.ndarray, int]


def _collect(entries) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    r = np.concatenate([e[0] for e in entries])
    c = np.concatenate([e[1] for e in entries])
    v = np.concatenate([e[2] for e in entries])
    return r, c, v


def matpde(nx: int, ny: int | None = None, *, beta_c: float = 20.0,
           gamma_c: float = 0.0) -> Coo:
    """MATPDE-style non-symmetric 2D elliptic operator (paper section 6.1).

    Five-point central FD discretization of
        -(a u_x)_x - (b u_y)_y + beta*p u_x + gamma*q u_y
    with variable coefficients on an nx x ny grid, Dirichlet boundaries.
    """
    ny = nx if ny is None else ny
    hx, hy = 1.0 / (nx + 1), 1.0 / (ny + 1)
    ix = np.arange(1, nx + 1)
    iy = np.arange(1, ny + 1)
    X, Y = np.meshgrid(ix * hx, iy * hy, indexing="ij")          # (nx, ny)

    def a(x, y):
        return np.exp(-x * y)

    def b(x, y):
        return np.exp(x * y)

    def p(x, y):
        return beta_c * (x + y)

    def q(x, y):
        return gamma_c * (x * y)

    aE = a(X + hx / 2, Y) / hx**2
    aW = a(X - hx / 2, Y) / hx**2
    bN = b(X, Y + hy / 2) / hy**2
    bS = b(X, Y - hy / 2) / hy**2
    pc = p(X, Y) / (2 * hx)
    qc = q(X, Y) / (2 * hy)

    idx = (np.arange(nx)[:, None] * ny + np.arange(ny)[None, :])

    entries = []
    # center
    entries.append((idx.ravel(), idx.ravel(), (aE + aW + bN + bS).ravel()))
    # east (x+1)
    m = np.zeros((nx, ny), bool)
    m[:-1, :] = True
    entries.append((idx[m], idx[m] + ny, (-aE + pc)[m]))
    # west
    m = np.zeros((nx, ny), bool)
    m[1:, :] = True
    entries.append((idx[m], idx[m] - ny, (-aW - pc)[m]))
    # north (y+1)
    m = np.zeros((nx, ny), bool)
    m[:, :-1] = True
    entries.append((idx[m], idx[m] + 1, (-bN + qc)[m]))
    # south
    m = np.zeros((nx, ny), bool)
    m[:, 1:] = True
    entries.append((idx[m], idx[m] - 1, (-bS - qc)[m]))
    r, c, v = _collect(entries)
    return r, c, v, nx * ny


def laplace2d(nx: int, ny: int | None = None) -> Coo:
    return matpde(nx, ny, beta_c=0.0, gamma_c=0.0)


def anisotropic_laplace2d(nx: int, ny: int | None = None, *,
                          epsilon: float = 1e-2) -> Coo:
    """Anisotropic 2D Laplacian ``-eps u_xx - u_yy`` (5-point, Dirichlet).

    The canonical ill-conditioned SPD preconditioning benchmark: for
    ``epsilon << 1`` the strong coupling runs along grid lines in ``y``
    (the fast index — ``idx = ix * ny + iy``), so plain CG converges
    slowly while block-Jacobi with ``block_size = ny`` (line Jacobi over
    contiguous index blocks) captures the dominant coupling exactly.
    """
    ny = nx if ny is None else ny
    if epsilon <= 0:
        raise ValueError(f"epsilon must be positive, got {epsilon}")
    hx, hy = 1.0 / (nx + 1), 1.0 / (ny + 1)
    ax = epsilon / hx**2
    by = 1.0 / hy**2
    idx = (np.arange(nx)[:, None] * ny + np.arange(ny)[None, :])

    entries = [(idx.ravel(), idx.ravel(),
                np.full(nx * ny, 2.0 * ax + 2.0 * by))]
    # x-neighbors (stride ny), both triangles
    m = idx[:-1, :].ravel()
    entries.append((m, m + ny, np.full(m.size, -ax)))
    entries.append((m + ny, m, np.full(m.size, -ax)))
    # y-neighbors (stride 1), both triangles
    m = idx[:, :-1].ravel()
    entries.append((m, m + 1, np.full(m.size, -by)))
    entries.append((m + 1, m, np.full(m.size, -by)))
    r, c, v = _collect(entries)
    return r, c, v, nx * ny


def laplace3d(nx: int) -> Coo:
    """Standard 7-point 3D Laplacian on nx^3 grid."""
    n = nx**3
    i = np.arange(n)
    x, y, z = i // (nx * nx), (i // nx) % nx, i % nx
    entries = [(i, i, np.full(n, 6.0))]
    for (coord, stride) in ((x, nx * nx), (y, nx), (z, 1)):
        m = coord < nx - 1
        entries.append((i[m], i[m] + stride, np.full(m.sum(), -1.0)))
        entries.append((i[m] + stride, i[m], np.full(m.sum(), -1.0)))
    r, c, v = _collect(entries)
    return r, c, v, n


def anderson3d(nx: int, disorder: float = 16.5, seed: int = 0) -> Coo:
    """3D Anderson-localization Hamiltonian: hopping + random on-site
    disorder in [-W/2, W/2] (ESSEX application, topological disorder
    physics of section 1.1)."""
    rng = np.random.default_rng(seed)
    n = nx**3
    i = np.arange(n)
    x, y, z = i // (nx * nx), (i // nx) % nx, i % nx
    entries = [(i, i, rng.uniform(-disorder / 2, disorder / 2, n))]
    for (coord, stride) in ((x, nx * nx), (y, nx), (z, 1)):
        m = coord < nx - 1
        entries.append((i[m], i[m] + stride, np.full(m.sum(), -1.0)))
        entries.append((i[m] + stride, i[m], np.full(m.sum(), -1.0)))
    r, c, v = _collect(entries)
    return r, c, v, n


def graphene(nx: int, ny: int, *, t: float = -2.7, onsite_disorder: float = 0.0,
             seed: int = 0) -> Coo:
    """Honeycomb-lattice tight-binding Hamiltonian (graphene; paper 1.1).

    Brick-wall mapping of the honeycomb lattice onto an nx x ny grid with
    two-atom unit cells; nearest-neighbor hopping ``t``.
    """
    rng = np.random.default_rng(seed)
    n = nx * ny * 2

    def site(ix, iy, s):
        return (ix * ny + iy) * 2 + s

    rr, cc, vv = [], [], []
    for ix in range(nx):
        for iy in range(ny):
            a_ = site(ix, iy, 0)
            b_ = site(ix, iy, 1)
            # intra-cell bond
            rr += [a_, b_]
            cc += [b_, a_]
            vv += [t, t]
            # inter-cell bonds
            if iy + 1 < ny:
                nb = site(ix, iy + 1, 0)
                rr += [b_, nb]
                cc += [nb, b_]
                vv += [t, t]
            if ix + 1 < nx:
                nb = site(ix + 1, iy, 0)
                rr += [b_, nb]
                cc += [nb, b_]
                vv += [t, t]
    if onsite_disorder:
        i = np.arange(n)
        rr += i.tolist()
        cc += i.tolist()
        vv += rng.uniform(-onsite_disorder / 2, onsite_disorder / 2, n).tolist()
    return (np.asarray(rr, np.int64), np.asarray(cc, np.int64),
            np.asarray(vv, np.float64), n)


def spin_chain_xx(L: int, jz: float = 1.0) -> Coo:
    """XXZ spin-1/2 chain in the Sz=0-free full basis (2^L), sparse
    Hamiltonian — the 'no mesh interpretation, indefinite' matrix class the
    paper emphasizes (section 1.3)."""
    n = 1 << L
    states = np.arange(n, dtype=np.int64)
    rr, cc, vv = [], [], []
    diag = np.zeros(n)
    for i in range(L - 1):
        bi = (states >> i) & 1
        bj = (states >> (i + 1)) & 1
        # S^z_i S^z_{i+1}
        diag += jz * 0.25 * np.where(bi == bj, 1.0, -1.0)
        # flip-flop (S+S- + S-S+)/2
        m = bi != bj
        flipped = states[m] ^ ((1 << i) | (1 << (i + 1)))
        rr.append(states[m])
        cc.append(flipped)
        vv.append(np.full(m.sum(), 0.5))
    rr.append(states)
    cc.append(states)
    vv.append(diag)
    return (np.concatenate(rr), np.concatenate(cc), np.concatenate(vv), n)


def banded_random(n: int, bw: int = 16, density: float = 0.4,
                  seed: int = 0, *, sym: bool = False) -> Coo:
    """Random banded matrix (cage15 stand-in): ~density filled band."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    rows, cols, vals = [i], [i], [rng.standard_normal(n) + bw]
    for d in range(1, bw + 1):
        m = rng.random(n - d) < density
        idx = i[: n - d][m]
        v = rng.standard_normal(m.sum())
        rows += [idx, idx + d]
        cols += [idx + d, idx]
        vals += [v, v if sym else rng.standard_normal(m.sum())]
    r, c, v = _collect(list(zip(rows, cols, vals)))
    return r, c, v, n
