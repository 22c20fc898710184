"""Complex values in the port against the JAX package, on the CPU.

The same phased (complex Hermitian positive definite) matrices, made with
numpy from a seed (``torch_complex_matrix.py``), go through both packages
in complex64 and complex128:

* B1's plain path (``kernels.ops.sellcs_spmv`` on CPU tensors; the JAX
  ``ops.sellcs_spmv`` cascades complex to ``spmv_ref``) with every fusion
  flag, complex coefficients and a real x: within 1e-12 (complex128) or
  1e-5 (complex64) of max |want|;
* ``tsmttsm`` (conj on and off, with and without Kahan), ``tsmm``
  (complex and real X) and ``block_jacobi_apply`` (complex and real x) at
  the same tolerances;
* column CG and MINRES, block CG and block MINRES, and block-Jacobi PCG
  and PMINRES: equal iteration counts (one SpMV sweep an iteration in
  both packages, so equal sweeps), x within 1e-10 (complex128) or 1e-4
  (complex64) of the JAX x, relative to max |x|;
* Lanczos with reorthogonalisation: alpha and beta within 1e-10;
* ``dist_spmv`` on 2 host shards against the JAX ``dist_spmv`` on 2
  forced host devices (a subprocess).

The JAX side runs complex128 under ``jax.enable_x64``.  Pipelined CG,
ChebFD and KPM conjugate in the port and not in the JAX package (a
deliberate difference): the port's pipelined CG is held to plain CG's
count and the JAX one to its non-convergence; ChebFD and KPM are held to
the dense eigendecomposition.
"""
import contextlib
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from conftest import run_with_devices  # noqa: E402
from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core import spmv as jspmv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.solvers import make_operator as jmake_operator  # noqa: E402
from repro.solvers import make_preconditioner as jmake_preconditioner  # noqa: E402
from repro_torch.core import SpmvOpts, from_coo  # noqa: E402
from repro_torch.core.distributed import dist_from_coo, dist_spmv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.solvers import (cg, lanczos, make_operator,  # noqa: E402
                                 make_preconditioner, minres)
from torch_complex_matrix import (dense, phased_aniso,  # noqa: E402
                                  phased_laplace3d)

jcg = importlib.import_module("repro.solvers.cg")
jminres = importlib.import_module("repro.solvers.minres")
jlanczos = importlib.import_module("repro.solvers.lanczos")

CDTYPES = {"complex128": np.complex128, "complex64": np.complex64}
REAL = {np.complex128: np.float64, np.complex64: np.float32}
#: kernel-level tolerance (of max |want|) and solution tolerance
TOL = {np.complex128: 1e-12, np.complex64: 1e-5}
X_TOL = {np.complex128: 1e-10, np.complex64: 1e-4}


def _x64(dtype):
    return (jax.enable_x64(True) if dtype == np.complex128
            else contextlib.nullcontext())


def _crandn(rng, shape, dtype):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def close(got, want, rtol):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    assert np.abs(got - want).max(initial=0.0) <= rtol * scale, (
        np.abs(got - want).max(), rtol * scale)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# --------------------------------------------------------------- the matrix
@pytest.mark.parametrize("which", ["laplace3d", "aniso"])
def test_phased_matrix_is_hermitian_positive_definite(which):
    """H = H^H, the phases are not trivial, and lambda_min(H) >=
    lambda_min(L) > 0 (Kato)."""
    r, c, hv, n, v = (phased_laplace3d(5, seed=3) if which == "laplace3d"
                      else phased_aniso(12, seed=3))
    H, L = dense(r, c, hv, n), dense(r, c, v, n)
    np.testing.assert_array_equal(H, H.conj().T)
    assert np.abs(H.imag).max() > 0.1
    np.testing.assert_allclose(np.abs(H), np.abs(L), rtol=1e-15, atol=0)
    lh, ll = np.linalg.eigvalsh(H)[0], np.linalg.eigvalsh(L)[0]
    assert ll > 0 and lh >= ll - 1e-12


def test_phased_values_follow_the_seed():
    a = phased_laplace3d(4, seed=1)[2]
    np.testing.assert_array_equal(a, phased_laplace3d(4, seed=1)[2])
    assert not np.array_equal(a, phased_laplace3d(4, seed=2)[2])


# ------------------------------------------------------------------------ B1
def _b1_problem(dtype, seed=0):
    r, c, hv, n, _ = phased_laplace3d(6, seed=seed)
    kw = dict(C=8, sigma=32, dtype=dtype)
    return (from_coo(r, c, hv, (n, n), device="cpu", **kw),
            (r, c, hv, n, kw))


FLAGS = {
    "plain": (dict(), False, False),
    "alpha_beta": (dict(alpha=0.7 - 0.2j, beta=-1.3 + 0.4j), True, False),
    "gamma_scalar": (dict(alpha=1.2 + 0.5j, gamma=0.25 - 0.75j), False,
                     False),
    "gamma_column": (dict(gamma="column"), True, False),
    "chain": (dict(alpha=1.1j, beta=0.5, delta=0.3 - 0.1j, eta=-0.8 + 0.6j),
              True, True),
    "dots": (dict(dot_yy=True, dot_xy=True, dot_xx=True), False, False),
    "everything": (dict(alpha=0.9 + 0.1j, beta=0.4j, gamma="column",
                        delta=2.0, eta=0.5 - 0.5j, dot_yy=True, dot_xy=True,
                        dot_xx=True), True, True),
}


@pytest.mark.parametrize("real_x", [False, True])
@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("dname", sorted(CDTYPES))
def test_b1_plain_path_matches_jax(dname, flag, real_x):
    dtype = CDTYPES[dname]
    A, (r, c, hv, n, kw) = _b1_problem(dtype)
    kwargs, with_y, with_z = FLAGS[flag]
    rng = np.random.default_rng(5)
    b = 3
    kwargs = dict(kwargs)
    if kwargs.get("gamma") == "column":
        kwargs["gamma"] = _crandn(rng, b, dtype)
    x = (rng.standard_normal((A.nrows_pad, b)).astype(REAL[dtype]) if real_x
         else _crandn(rng, (A.nrows_pad, b), dtype))
    y = _crandn(rng, (A.nrows_pad, b), dtype) if with_y else None
    z = _crandn(rng, (A.nrows_pad, b), dtype) if with_z else None
    yt, zt, dt = ops.sellcs_spmv(A, _t(x), _t(y), _t(z), SpmvOpts(**kwargs))
    with _x64(dtype):
        Aj = jfrom_coo(r, c, hv, (n, n), **kw)
        yj, zj, dj = jops.sellcs_spmv(Aj, _j(x), _j(y), _j(z),
                                      jspmv.SpmvOpts(**kwargs))
        yj, zj, dj = (None if a is None else np.asarray(a)
                      for a in (yj, zj, dj))
    assert yt.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    close(yt.numpy(), yj, TOL[dtype])
    assert (zt is None) == (zj is None)
    if zt is not None:
        close(zt.numpy(), zj, TOL[dtype])
    assert (dt is None) == (dj is None)
    if dt is not None:
        assert dt.dtype == torch.complex128
        close(dt.numpy(), dj, TOL[dtype])


@pytest.mark.parametrize("dname", sorted(CDTYPES))
def test_b5_wide_block_plain_path_matches_jax(dname):
    """B5's complex plain path at bw = 300 (past one thread block's 256
    slots on the card) against the JAX op, which takes its plain path for
    complex values, with per-column a and a scalar b: y' within TOL of
    max |y'|; the port's dots, conjugate-linear in the first argument,
    against the conjugated sums of the JAX y' (the JAX package's dots do
    not conjugate, a deliberate difference)."""
    dtype = CDTYPES[dname]
    rng = np.random.default_rng(12)
    x, y = (_crandn(rng, (53, 300), dtype) for _ in range(2))
    a, b = _crandn(rng, 300, dtype), 0.25 - 0.75j
    out, dots = ops.fused_axpby_dots(_t(x), _t(y), _t(a), b, dot_yy=True,
                                     dot_xy=True, dot_xx=True)
    with _x64(dtype):
        jo, _ = jops.fused_axpby_dots(_j(x), _j(y), _j(a), b)
        jo = np.asarray(jo)
    assert dots.shape == (3, 300)
    close(out.numpy(), jo, TOL[dtype])
    yn, xc = jo.astype(np.complex128), x.astype(np.complex128)
    close(dots.numpy(), np.stack([np.sum(yn.conj() * yn, 0),
                                  np.sum(xc.conj() * yn, 0),
                                  np.sum(xc.conj() * xc, 0)]), TOL[dtype])


# ------------------------------------------------------------------- B2, B3
@pytest.mark.parametrize("with_x", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
@pytest.mark.parametrize("conj", [True, False])
@pytest.mark.parametrize("dname", sorted(CDTYPES))
def test_tsmttsm_matches_jax(dname, conj, kahan, with_x):
    dtype = CDTYPES[dname]
    rng = np.random.default_rng(7)
    V, W, X = (_crandn(rng, s, dtype) for s in ((301, 5), (301, 4), (5, 4)))
    alpha, beta = (0.5 - 0.5j, -2.0 + 1.0j) if with_x else (1.0, 0.0)
    Xo = X if with_x else None
    got = ops.tsmttsm(_t(V), _t(W), _t(Xo), alpha, beta, kahan=kahan,
                      conj=conj)
    with _x64(dtype):
        want = np.asarray(jops.tsmttsm(_j(V), _j(W), _j(Xo), alpha, beta,
                                       kahan=kahan, conj=conj))
    assert got.dtype == _t(V).dtype
    close(got.numpy(), want, TOL[dtype])


@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("x_kind", ["complex", "real"])
@pytest.mark.parametrize("dname", sorted(CDTYPES))
def test_tsmm_matches_jax(dname, x_kind, with_w):
    dtype = CDTYPES[dname]
    rng = np.random.default_rng(8)
    V, W = _crandn(rng, (301, 5), dtype), _crandn(rng, (301, 4), dtype)
    X = (_crandn(rng, (5, 4), dtype) if x_kind == "complex"
         else rng.standard_normal((5, 4)).astype(REAL[dtype]))
    alpha, beta = (0.5 - 0.5j, -2.0 + 1.0j) if with_w else (1.5j, 0.0)
    Wo = W if with_w else None
    got = ops.tsmm(_t(V), _t(X), _t(Wo), alpha, beta)
    with _x64(dtype):
        want = np.asarray(jops.tsmm(_j(V), _j(X), _j(Wo), alpha, beta))
    assert got.dtype == _t(V).dtype
    close(got.numpy(), want, TOL[dtype])


# ------------------------------------------------------------------------ B4
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("x_kind", ["complex", "real"])
@pytest.mark.parametrize("dname", sorted(CDTYPES))
def test_block_jacobi_apply_matches_jax(dname, x_kind, b):
    dtype = CDTYPES[dname]
    rng = np.random.default_rng(9)
    blocks = _crandn(rng, (6, 8, 8), dtype)
    x = (_crandn(rng, (48, b), dtype) if x_kind == "complex"
         else rng.standard_normal((48, b)).astype(REAL[dtype]))
    got = ops.block_jacobi_apply(_t(blocks), _t(x))
    with _x64(dtype):
        want = np.asarray(jops.block_jacobi_apply(_j(blocks), _j(x)))
    assert got.dtype == _t(blocks).dtype
    close(got.numpy(), want, TOL[dtype])


# ------------------------------------------------------------------ solvers
def _solve_pair(solver, dtype, *, block=False, precond=False, tol, width=4):
    """One solve through both packages on the same phased matrix and
    right-hand side; returns the port's and the JAX package's
    ``(iterations, converged, x)`` in original space."""
    if precond:
        r, c, hv, n, _ = phased_aniso(16, seed=11)
        kw = dict(C=16, sigma=1, dtype=dtype)
    else:
        r, c, hv, n, _ = phased_laplace3d(8, seed=11)
        kw = dict(C=8, sigma=32, dtype=dtype)
    b = _crandn(np.random.default_rng(12), (n, width), dtype)
    A = from_coo(r, c, hv, (n, n), device="cpu", **kw)
    M = make_preconditioner("block_jacobi:16", matrix=A) if precond else None
    fn = {"cg": cg, "minres": minres}[solver]
    res = fn(make_operator(A), A.permute(_t(b)), tol=tol, maxiter=500,
             block=block, M=M)
    port = (int(res.iters), res.converged.numpy(),
            A.unpermute(res.x).numpy())
    with _x64(dtype):
        Aj = jfrom_coo(r, c, hv, (n, n), **kw)
        Mj = (jmake_preconditioner("block_jacobi:16", matrix=Aj)
              if precond else None)
        jfn = {"cg": jcg.cg, "minres": jminres.minres}[solver]
        rj = jfn(jmake_operator(Aj, impl="ref"), Aj.permute(jnp.asarray(b)),
                 tol=tol, maxiter=500, block=block, M=Mj)
        ref = (int(rj.iters), np.asarray(rj.converged),
               np.asarray(Aj.unpermute(rj.x)))
    return port, ref


SOLVES = {
    "column_cg": dict(solver="cg"),
    "column_minres": dict(solver="minres"),
    "block_cg": dict(solver="cg", block=True),
    "block_minres": dict(solver="minres", block=True),
    "pcg": dict(solver="cg", precond=True),
    "pminres": dict(solver="minres", precond=True),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
@pytest.mark.parametrize("dname", sorted(CDTYPES))
def test_solvers_match_jax(dname, case):
    dtype = CDTYPES[dname]
    tol = 1e-8 if dtype == np.complex128 else 1e-4
    (it, conv, x), (itj, convj, xj) = _solve_pair(dtype=dtype, tol=tol,
                                                  **SOLVES[case])
    assert conv.all() and convj.all()
    assert it == itj
    assert x.dtype == np.dtype(dtype)
    close(x, xj, X_TOL[dtype])


def test_pipelined_cg_converges_on_complex_in_the_port_not_in_jax():
    """The port's pipelined CG conjugates its two dots (<r, r> and
    <r, w>) and converges on a phased matrix in plain CG's count (22
    iterations here); the JAX package's sums do not conjugate, so its
    pipelined CG runs to ``maxiter`` without converging (a deliberate
    difference, ``ROADMAP.md``, "Facts about the reference")."""
    r, c, hv, n, _ = phased_laplace3d(8, seed=11)
    kw = dict(C=8, sigma=32, dtype=np.complex128)
    A = from_coo(r, c, hv, (n, n), device="cpu", **kw)
    b = _crandn(np.random.default_rng(12), (n, 4), np.complex128)
    cg_mod = importlib.import_module("repro_torch.solvers.cg")
    plain = cg(make_operator(A), A.permute(_t(b)), tol=1e-8, maxiter=200)
    piped = cg_mod.pipelined_cg(make_operator(A), A.permute(_t(b)),
                                tol=1e-8, maxiter=200)
    with _x64(np.complex128):
        Aj = jfrom_coo(r, c, hv, (n, n), **kw)
        pj = jcg.pipelined_cg(jmake_operator(Aj, impl="ref"),
                              Aj.permute(jnp.asarray(b)), tol=1e-8,
                              maxiter=200)
        pj_iters, pj_conv = int(pj.iters), np.asarray(pj.converged)
    assert bool(plain.converged.all()) and int(plain.iters) == 22
    assert bool(piped.converged.all())
    assert int(piped.iters) == int(plain.iters)
    Ad = dense(r, c, hv, n)
    x = A.unpermute(piped.x).numpy()
    rel = (np.linalg.norm(b - Ad @ x, axis=0)
           / np.linalg.norm(b, axis=0))
    assert rel.max() <= 10 * 1e-8, rel
    assert not pj_conv.any() and pj_iters == 200


# ------------------------------------------------------------------ Lanczos
@pytest.mark.parametrize("dname", sorted(CDTYPES))
def test_lanczos_reorth_matches_jax(dname):
    dtype = CDTYPES[dname]
    r, c, hv, n, _ = phased_laplace3d(8, seed=13)
    kw = dict(C=8, sigma=32, dtype=dtype)
    A = from_coo(r, c, hv, (n, n), device="cpu", **kw)
    v0 = A.permute(_t(_crandn(np.random.default_rng(14), n, dtype)))
    res = lanczos(make_operator(A), v0, 20, reorth=True)
    with _x64(dtype):
        Aj = jfrom_coo(r, c, hv, (n, n), **kw)
        rj = jlanczos.lanczos(jmake_operator(Aj, impl="ref"),
                              jnp.asarray(v0.numpy()), 20, reorth=True)
        aj, bj = np.asarray(rj.alphas), np.asarray(rj.betas)
    tol = 1e-10 if dtype == np.complex128 else 1e-4
    np.testing.assert_allclose(res.alphas.numpy(), aj, rtol=tol, atol=tol)
    np.testing.assert_allclose(res.betas.numpy(), bj, rtol=tol, atol=tol)


# ------------------------------------------------------------ ChebFD, KPM
def test_chebfd_complex_ritz_values_match_eigvalsh():
    """ChebFD on a phased laplace3d(6) in complex128, aimed at the lowest
    eigenvalues: every converged Ritz value (residual below 1e-6) lies
    within 1e-6 of ``numpy.linalg.eigvalsh`` of the dense matrix, the
    tolerance of the real test in ``test_torch_eigen.py``."""
    from repro_torch.solvers import chebfd
    r, c, hv, n, _ = phased_laplace3d(6, seed=5)
    lam = np.linalg.eigvalsh(dense(r, c, hv, n))
    A = from_coo(r, c, hv, (n, n), device="cpu", C=8, sigma=32,
                 dtype=np.complex128)
    target = (lam[0] - 0.05, 0.5 * (lam[3] + lam[4]))
    res = chebfd(make_operator(A), target, block_size=8, degree=80,
                 sweeps=4, spectrum=(lam[0] - 0.1, lam[-1] + 0.1))
    assert res.eigenvalues.dtype == np.float64
    conv = res.residuals < 1e-6
    assert conv.sum() >= 4, res.residuals
    got = res.eigenvalues[conv]
    near = lam[np.abs(lam[None, :] - got[:, None]).argmin(1)]
    np.testing.assert_allclose(got, near, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:4], lam[:4], rtol=0, atol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_kpm_complex_moments_match_the_dense_eigendecomposition(fused):
    """KPM on a phased laplace3d(5) (125 rows, padded to 128) in
    complex128: the moments lie within 2e-5 of the exact
    mean_p <v_p, T_k(As) v_p>, built from the dense eigendecomposition and
    the port's own probes, the tolerance of the real test in
    ``test_torch_eigen.py``; no cast drops an imaginary part."""
    import warnings
    from repro_torch.solvers import kpm_dos_moments
    r, c, hv, n, _ = phased_laplace3d(5, seed=6)
    lam, U = np.linalg.eigh(dense(r, c, hv, n))
    A = from_coo(r, c, hv, (n, n), device="cpu", C=8, sigma=32,
                 dtype=np.complex128)
    lo, hi = lam[0] - 0.1, lam[-1] + 0.1
    M, P, seed = 24, 4, 3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = kpm_dos_moments(make_operator(A), M, n_probes=P,
                              spectrum=(lo, hi), seed=seed,
                              fused=fused).numpy()
    g = torch.Generator(device="cpu").manual_seed(seed)
    bits = (torch.rand((n, P), generator=g) < 0.5).numpy()
    v = np.where(bits, 1.0, -1.0) / np.sqrt(n)
    s = (lam - 0.5 * (hi + lo)) / (0.5 * (hi - lo))
    w = np.abs(U.conj().T @ v) ** 2                  # (n, P)
    exact = (np.cos(np.arange(M)[:, None] * np.arccos(s)[None, :])
             @ w).mean(1)
    assert got.dtype == np.float32 and got.shape == (M,)
    np.testing.assert_allclose(got, exact, rtol=0, atol=2e-5)
    mu2 = (2 * np.sum(np.abs((np.diag(s) @ U.conj().T @ v)) ** 2, 0)
           - np.sum(v * v, 0)).mean()
    assert abs(got[2] - mu2) <= 2e-5


# -------------------------------------------------------------- dist_spmv
REF_CODE = """
import numpy as np, jax
jax.config.update("jax_enable_x64", True)
from jax.sharding import Mesh
from repro.core.distributed import dist_from_coo, dist_spmv
from repro.core.spmv import SpmvOpts
import sys
sys.path.insert(0, {tests!r})
from torch_complex_matrix import phased_laplace3d
r, c, hv, n, _ = phased_laplace3d(8, seed=17)
x = (np.random.default_rng(18).standard_normal((n, 3))
     + 1j * np.random.default_rng(19).standard_normal((n, 3)))
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
D = dist_from_coo(r, c, hv, n, nshards=2, C=8, sigma=32,
                  dtype=np.complex128)
opts = SpmvOpts(alpha=0.5 - 1.5j, gamma=0.25 + 0.5j, dot_yy=True,
                dot_xy=True, dot_xx=True)
y, d = dist_spmv(D, mesh, x, opts=opts, impl="ref")
np.savez({path!r}, y=np.asarray(y), dots=np.asarray(d))
print("SUBPROCESS_OK")
"""


@pytest.fixture(scope="module")
def dist_ref(tmp_path_factory):
    from pathlib import Path
    path = str(tmp_path_factory.mktemp("cx_dist_ref") / "ref.npz")
    tests = str(Path(__file__).resolve().parent)
    assert "SUBPROCESS_OK" in run_with_devices(
        REF_CODE.format(path=path, tests=tests), 2)
    return dict(np.load(path))


@pytest.mark.parametrize("overlap", [True, False])
def test_dist_spmv_on_two_host_shards_matches_jax(dist_ref, overlap):
    """y within 1e-12 of the JAX package's.  The dots are the conjugated
    sums <u, v> = sum conj(u) v, as both packages' one-device SpMV forms
    them; the JAX package's distributed epilogue
    (``repro/core/distributed.py:fused_epilogue``) sums u v unconjugated,
    so its dots are held to that form, from its own y."""
    r, c, hv, n, _ = phased_laplace3d(8, seed=17)
    x = (np.random.default_rng(18).standard_normal((n, 3))
         + 1j * np.random.default_rng(19).standard_normal((n, 3)))
    D = dist_from_coo(r, c, hv, n, nshards=2, devices=["cpu", "cpu"], C=8,
                      sigma=32, dtype=np.complex128)
    opts = SpmvOpts(alpha=0.5 - 1.5j, gamma=0.25 + 0.5j, dot_yy=True,
                    dot_xy=True, dot_xx=True)
    y, d = dist_spmv(D, None, x, opts=opts, overlap=overlap)
    assert y.dtype == torch.complex128 and d.dtype == torch.complex128
    yj = dist_ref["y"]
    close(y.numpy(), yj, 1e-12)
    close(d.numpy(), [np.sum(yj.conj() * yj, 0), np.sum(x.conj() * yj, 0),
                      np.sum(x.conj() * x, 0)], 1e-12)
    close(dist_ref["dots"], [np.sum(yj * yj, 0), np.sum(x * yj, 0),
                             np.sum(x * x, 0)], 1e-12)


# ------------------------------------------------- chip_smoke.py's phases
REPO = __import__("pathlib").Path(__file__).resolve().parents[1]


def test_chip_smoke_phases_the_same_values(monkeypatch):
    """``chip_smoke.py:phased`` (the card's matrices) gives the helper's
    values to the bit."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    from repro_torch.matrices import laplace3d
    r, c, v, n = laplace3d(5)
    np.testing.assert_array_equal(chip_smoke.phased(r, c, v, n, 4),
                                  phased_laplace3d(5, seed=4)[2])


def test_chip_smoke_complex_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's complex grid and complex solves at a small size on
    the CPU: the plain versions stand in for the kernels (the launch
    counts are then 0), so this checks the phases' shapes, bounds and
    control flow, not the kernels."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    from repro_torch.matrices import laplace3d
    for name, value in (("DEVICE", "cpu"), ("NX", 10),
                        ("CX_TSM_NS", (37, 300)), ("CX_TSM_DIMS", (1, 5, 16)),
                        ("CX_B4_NB", (1, 7)), ("CX_PRECOND_NX", 32),
                        ("B5_WIDE_NS", (0, 37))):
        monkeypatch.setattr(chip_smoke, name, value)
    chip_smoke.phase_complex_grid()
    fw = {"coo": laplace3d(10), "iters64": 0}
    cx = chip_smoke.phase_complex_solves(fw, {"iters": 0}, 0, "cpu")
    assert cx["A"].dtype == torch.complex128
    assert cx["cg complex64"]["iters"] < cx["cg complex128"]["iters"]
    # the timing phase's rows (B1 and B2 in both complex types) with each
    # call run once in place of the card's timer
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "PRECOND_NX", 64)
    rows = chip_smoke.phase_complex_timing(cx, "cpu")
    for ct in (torch.complex128, torch.complex64):
        for b in (1, 4, 8, 16):
            assert rows[("sellcs_spmv", ct, b)]["bound_ms"] > 0
        for kahan in (True, False):
            assert rows[("tsmttsm", ct, kahan)]["library_ms"] == 1.0
        assert rows[("fused_axpby_dots", ct)]["bound_ms"] > 0
