"""Parity of the port's column MINRES stepper (``repro_torch.solvers.minres``)
with the JAX package's, on the CPU.

The problems are an indefinite diagonal-plus-Laplacian matrix (MINRES'
reason to exist) and the SPD case-study matrix.  float64 (the JAX side
under ``jax.enable_x64``) must take exactly the reference's iteration
count, with iterates equal to rtol 1e-9 of the largest entry (the column
dots sum in other orders); float32 within one iteration and 1e-3.
"""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.solvers import make_operator as jmake_operator  # noqa: E402
from repro_torch.core import from_coo, to_dense  # noqa: E402
from repro_torch.interop import state_from_arrays  # noqa: E402
from repro_torch.matrices import laplace2d, matpde  # noqa: E402
from repro_torch.solvers import (MinresState, make_operator,  # noqa: E402
                                 make_preconditioner, minres,
                                 minres_finalize, minres_init, minres_step)

jmin = importlib.import_module("repro.solvers.minres")


def indefinite(dtype, width=3):
    """laplace2d(12) shifted into indefiniteness: eigenvalues on both sides
    of zero, none within 0.06 of it."""
    r, c, v, n = laplace2d(12)
    v = np.asarray(v, np.float64).copy()
    v[r == c] -= 3.3
    kw = dict(C=8, sigma=16, dtype=dtype)
    A = from_coo(r, c, v, (n, n), device="cpu", **kw)
    b = np.random.default_rng(1).standard_normal((n, width)).astype(dtype)
    return A, b, (r, c, v, n, kw)


def case_study(dtype):
    r, c, v, n = matpde(16, beta_c=0.0)
    kw = dict(C=16, sigma=32, w_align=4, dtype=dtype)
    A = from_coo(r, c, v, (n, n), device="cpu", **kw)
    b = np.random.default_rng(0).standard_normal((n, 2)).astype(dtype)
    return A, b, (r, c, v, n, kw)


def jax_minres(coo, b, x64, **kw):
    r, c, v, n, build = coo
    with jax.enable_x64(x64):
        Aj = jfrom_coo(r, c, v, (n, n), **build)
        res = jmin.minres(jmake_operator(Aj, impl="ref"), Aj.permute(b), **kw)
        return (int(res.iters), np.asarray(res.converged),
                np.asarray(Aj.unpermute(res.x)), np.asarray(res.resnorm))


@pytest.mark.parametrize("make", [indefinite, case_study],
                         ids=["indefinite", "case_study"])
@pytest.mark.parametrize("dtype,slack", [(np.float64, 0), (np.float32, 1)])
def test_minres_matches_jax(make, dtype, slack):
    A, b, coo = make(dtype)
    x64 = dtype == np.float64
    tol = 1e-9 if x64 else 1e-5
    j_iters, j_conv, j_x, j_res = jax_minres(coo, b, x64, tol=tol,
                                             maxiter=800)
    res = minres(make_operator(A), A.permute(b), tol=tol, maxiter=800)
    assert j_conv.all() and bool(res.converged.all())
    assert abs(res.iters - j_iters) <= slack
    x = A.unpermute(res.x).numpy()
    np.testing.assert_allclose(x, j_x, atol=(1e-9 if x64 else 1e-3)
                               * np.abs(j_x).max())
    # every column meets the tolerance in its true residual
    Ad = to_dense(A).astype(np.float64)
    true = np.linalg.norm(Ad @ x.astype(np.float64) - b, axis=0)
    bn = np.linalg.norm(b.astype(np.float64), axis=0)
    assert np.all(true / bn <= (10 * tol if x64 else 1e-3))


@pytest.mark.parametrize("k", [1, 7, 100])
def test_minres_chunked_equals_monolithic(k):
    A, b, _ = indefinite(np.float32)
    op = make_operator(A)
    bp = A.permute(b)
    st = minres_step(op, minres_init(op, bp, tol=1e-5, maxiter=300), 600)
    st2 = minres_init(op, bp, tol=1e-5, maxiter=300)
    while st2.it < st2.maxiter and not bool(st2.done.all()):
        st2 = minres_step(op, st2, k)
    assert isinstance(st, MinresState)
    assert torch.equal(st.x, st2.x) and st.it == st2.it
    mono = minres(op, bp, tol=1e-5, maxiter=300)
    assert torch.equal(mono.x, st.x)


def test_minres_per_column_tolerance_and_zero_rhs():
    A, b, coo = indefinite(np.float64)
    b[:, 2] = 0.0
    tol = np.array([1e-4, 1e-10, 1e-6])
    op = make_operator(A)
    st = minres_init(op, A.permute(b), tol=tol)
    assert bool(st.done[2]) and not bool(st.done[0])
    res = minres(op, A.permute(b), tol=tol, maxiter=800)
    j_iters, j_conv, _, _ = jax_minres(coo, b, True, tol=jnp.asarray(tol),
                                       maxiter=800)
    assert res.iters == j_iters and bool(res.converged.all())
    assert torch.count_nonzero(res.x[:, 2]) == 0


def test_minres_one_dimensional_rhs():
    A, b, coo = indefinite(np.float64, width=1)
    res = minres(make_operator(A), A.permute(b[:, 0]), tol=1e-9, maxiter=800)
    assert res.x.ndim == 1 and bool(res.converged)
    j_iters, _, _, _ = jax_minres(coo, b[:, 0], True, tol=1e-9, maxiter=800)
    assert res.iters == j_iters


def test_jax_minres_state_continues_in_the_port():
    A, b, coo = indefinite(np.float64)
    r, c, v, n, build = coo
    with jax.enable_x64(True):
        Aj = jfrom_coo(r, c, v, (n, n), **build)
        jop = jmake_operator(Aj, impl="ref")
        jst = jmin.minres_step(jop, jmin.minres_init(
            jop, Aj.permute(b), tol=1e-9, maxiter=800), 15)
        arrays = {f: np.asarray(getattr(jst, f)) for f in jst._fields}
        jfinal = jmin.minres_finalize(jmin.minres_step(jop, jst, 800))
        j_iters, j_x = int(jfinal.iters), np.asarray(jfinal.x)
    st = state_from_arrays(arrays, device="cpu")
    assert type(st) is MinresState and st.it == 15
    res = minres_finalize(minres_step(make_operator(A), st, 800))
    assert res.iters == j_iters
    np.testing.assert_allclose(res.x.numpy(), j_x,
                               atol=1e-9 * np.abs(j_x).max())


def test_minres_preconditioning_raises():
    """Preconditioned MINRES runs in the port (parity in
    test_torch_precond.py); what raises is what the reference refuses: a
    state and an ``M`` that do not belong together."""
    A, b, _ = indefinite(np.float32)
    op = make_operator(A)
    M = make_preconditioner("block_jacobi_abs:8", matrix=A)
    res = minres(op, A.permute(b), tol=1e-5, maxiter=800, M=M)
    assert type(minres_init(op, A.permute(b), M=M)).__name__ == \
        "PrecondMinresState"
    assert bool(res.converged.all())
    st = minres_init(op, A.permute(b))
    with pytest.raises(ValueError, match="without a preconditioner"):
        minres_step(op, st, 3, M=M)
    with pytest.raises(ValueError, match="with a preconditioner"):
        minres_step(op, minres_init(op, A.permute(b), M=M), 3)
