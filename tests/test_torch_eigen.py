"""Parity of the port's eigensolvers (``repro_torch.solvers.lanczos``,
``chebfd``, ``kpm``) with the JAX package's, on the CPU.

The two packages draw start vectors from different generators
(``torch.Generator`` and ``jax.random``), so the comparisons avoid shared
randomness: Lanczos gets an explicit ``v0`` made with numpy; ChebFD and
KPM run on **diagonal** matrices, where the Ritz values are fixed by the
spectrum and a Rademacher probe's Hutchinson trace is exact whatever its
signs.  float64 runs the JAX side under ``jax.enable_x64``.

Tolerances: Lanczos coefficients agree to 1e-10 relative (a 20-step
recurrence summed in other orders); converged Ritz values lie within
their residual of the true eigenvalues; float32 KPM moments agree to
2e-5 (32 Chebyshev steps of float32 vectors).
"""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.solvers import make_operator as jmake_operator  # noqa: E402
from repro_torch.core import from_coo  # noqa: E402
from repro_torch.matrices import laplace2d  # noqa: E402
from repro_torch.solvers import (MatrixFreeOperator, chebfd,  # noqa: E402
                                 jackson_kernel, kpm_dos_moments, lanczos,
                                 lanczos_extrema, make_operator)
from repro_torch.solvers.chebfd import _cheb_filter  # noqa: E402
from repro_torch.solvers.kpm import kpm_dos  # noqa: E402
from repro_torch.solvers.lanczos import randn  # noqa: E402

jlan = importlib.import_module("repro.solvers.lanczos")
jcheb = importlib.import_module("repro.solvers.chebfd")
jkpm = importlib.import_module("repro.solvers.kpm")


def both(r, c, v, n, dtype, **kw):
    """The port's operator and a function making the JAX package's (call it
    inside the right x64 scope)."""
    build = dict(C=8, sigma=1, dtype=dtype, **kw)
    A = from_coo(r, c, v, (n, n), device="cpu", **build)
    return make_operator(A), lambda: jmake_operator(
        jfrom_coo(r, c, v, (n, n), **build), impl="ref")


def diagonal(d, dtype):
    r = np.arange(len(d))
    return both(r, r, np.asarray(d, np.float64), len(d), dtype)


@pytest.mark.parametrize("reorth", [False, True])
def test_lanczos_matches_jax(reorth):
    r, c, v, n = laplace2d(12)
    op, jop = both(r, c, v, n, np.float64)
    v0 = np.random.default_rng(3).standard_normal(n)
    res = lanczos(op, torch.from_numpy(v0), 20, reorth=reorth,
                  keep_basis=True)
    with jax.enable_x64(True):
        jres = jlan.lanczos(jop(), jnp.asarray(v0), 20, reorth=reorth,
                            keep_basis=True)
        ja, jb = np.asarray(jres.alphas), np.asarray(jres.betas)
        jn = int(jres.nvalid)
    assert int(res.nvalid) == jn == 20
    np.testing.assert_allclose(res.alphas.numpy(), ja, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(res.betas.numpy(), jb, rtol=1e-10, atol=1e-12)
    # the kept basis is orthonormal to working precision with reorth
    if reorth:
        G = res.V.T @ res.V
        assert float((G - torch.eye(20, dtype=G.dtype)).abs().max()) < 1e-12


def test_lanczos_happy_breakdown():
    """A start vector that is an eigenvector exhausts the Krylov space in
    one step (w = A v - alpha v = 0 exactly): both packages report
    nvalid = 1, write nothing past it and keep the extrema bracket tight."""
    d = np.linspace(1.0, 4.0, 24)            # whole C=8 chunks: no padding
    op, jop = diagonal(d, np.float64)
    v0 = np.zeros(d.size)
    v0[3] = 1.0
    res = lanczos(op, torch.from_numpy(v0), 8, keep_basis=True)
    with jax.enable_x64(True):
        jres = jlan.lanczos(jop(), jnp.asarray(v0), 8, keep_basis=True)
        ja, jb, jn = (np.asarray(jres.alphas), np.asarray(jres.betas),
                      int(jres.nvalid))
    assert int(res.nvalid) == jn == 1
    np.testing.assert_array_equal(res.alphas.numpy(), ja)
    np.testing.assert_array_equal(res.betas.numpy(), jb)
    assert res.alphas[0] == d[3] and np.all(res.alphas.numpy()[1:] == 0)
    assert np.all(res.betas.numpy() == 0)
    assert torch.count_nonzero(res.V[:, 1:]) == 0
    # a 1-row operator: any start is an eigenvector
    lo, hi = lanczos_extrema(MatrixFreeOperator(lambda x: 2.0 * x, 1,
                                                torch.float64, "cpu"), k=12)
    assert 1.8 < lo <= 2.0 <= hi < 2.2


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lanczos_extrema_brackets_eigvalsh(dtype):
    r, c, v, n = laplace2d(12)
    op, _ = both(r, c, v, n, dtype)
    Ad = np.zeros((n, n))
    Ad[r, c] = v
    ev = np.linalg.eigvalsh(Ad)
    lo, hi = lanczos_extrema(op, k=30, seed=0)
    assert lo <= ev[0] and hi >= ev[-1]
    assert hi - lo <= 1.2 * (ev[-1] - ev[0])


def test_randn_is_seeded_and_typed():
    a = randn(5, (7, 3), torch.float64, "cpu")
    assert a.dtype == torch.float64 and a.shape == (7, 3)
    assert torch.equal(a, randn(5, (7, 3), torch.float64, "cpu"))
    z = randn(5, (4,), torch.complex64, "cpu")
    assert z.dtype == torch.complex64 and bool((z.imag != 0).any())


def test_cheb_filter_matches_jax():
    r, c, v, n = laplace2d(12)
    op, jop = both(r, c, v, n, np.float64)
    V = np.random.default_rng(5).standard_normal((n, 4))
    args = (25, 4.0, 4.0, 1.0, 2.0)          # degree, a, gamma, target
    got = _cheb_filter(op, torch.from_numpy(V), *args)
    with jax.enable_x64(True):
        want = np.asarray(jcheb._cheb_filter(jop(), jnp.asarray(V), *args))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-10 * np.abs(want).max())


def _gapped_spectrum():
    rng = np.random.default_rng(0)
    return np.concatenate([rng.uniform(0.0, 0.2, 200),
                           [0.30, 0.33, 0.36, 0.39],
                           rng.uniform(0.5, 1.0, 196)])


def test_chebfd_ritz_values_match_jax():
    """Four eigenvalues in the target window, the rest behind a gap: both
    packages converge to exactly those four, each within its residual."""
    d = _gapped_spectrum()
    inside = np.array([0.30, 0.33, 0.36, 0.39])
    op, jop = diagonal(d, np.float64)
    kw = dict(block_size=8, degree=60, sweeps=3, spectrum=(-0.01, 1.01))
    res = chebfd(op, (0.28, 0.41), **kw)
    with jax.enable_x64(True):
        jres = jcheb.chebfd(jop(), (0.28, 0.41), **kw)
    for ev, rn in ((res.eigenvalues, res.residuals),
                   (np.asarray(jres.eigenvalues), np.asarray(jres.residuals))):
        conv = rn < 1e-6
        np.testing.assert_allclose(ev[conv], inside, atol=1e-6)
        assert np.all(np.abs(ev[conv] - inside) <= rn[conv] + 1e-12)
    assert res.eigenvectors.shape == (d.size, 8)
    assert res.sweeps == 3


@pytest.mark.parametrize("fused", [True, False])
def test_kpm_moments_on_a_diagonal_match_jax(fused):
    """mu_m = mean_i T_m(s_i) exactly for Rademacher probes on a diagonal
    matrix, in both packages."""
    rng = np.random.default_rng(6)
    d = rng.uniform(-0.9, 1.7, 304)          # whole C=8 chunks: no padding
    op, jop = diagonal(d, np.float32)
    spec = (-1.0, 2.0)
    got = kpm_dos_moments(op, 32, n_probes=4, spectrum=spec, seed=0,
                          fused=fused).numpy()
    want = np.asarray(jkpm.kpm_dos_moments(jop(), 32, n_probes=4,
                                           spectrum=spec, seed=0,
                                           fused=fused))
    s = (d - 0.5) / 1.5
    exact = np.cos(np.arange(32)[:, None] * np.arccos(s)[None, :]).mean(1)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, exact, atol=2e-5)
    assert got[0] == pytest.approx(1.0, abs=1e-6)


def test_kpm_odd_moment_count_and_dos_match_jax():
    d = np.random.default_rng(7).uniform(-1.0, 1.0, 200)
    op, jop = diagonal(d, np.float32)
    spec = (-1.1, 1.1)
    got = kpm_dos_moments(op, 17, spectrum=spec).numpy()
    want = np.asarray(jkpm.kpm_dos_moments(jop(), 17, spectrum=spec))
    assert got.shape == want.shape == (17,)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(jackson_kernel(20), jkpm.jackson_kernel(20),
                               rtol=1e-15)
    e, rho = kpm_dos(op, 24, 50, spectrum=spec)
    je, jrho = jkpm.kpm_dos(jop(), 24, 50, spectrum=spec)
    np.testing.assert_allclose(e, np.asarray(je), rtol=1e-12)
    np.testing.assert_allclose(rho, np.asarray(jrho), atol=1e-4)
