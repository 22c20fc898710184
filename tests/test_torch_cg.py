"""Parity of the port's resumable CG steppers with the JAX package's.

The paper's case study (``tests/test_system.py``: MATPDE, C=16, sigma=32,
w_align=4, two right-hand sides, tol 1e-6) runs through both packages on
the CPU: float64 (the JAX side under ``jax.enable_x64``) must take exactly
the reference's iteration count, float32 within one iteration of it (the
two frameworks sum in different orders).  Chunked solves must equal
monolithic ones bit for bit.
"""
import contextlib
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.core import from_coo as jfrom_coo
from repro.solvers import make_operator as jmake_operator
from repro.solvers import stepper as jstepper
from repro_torch.core import from_coo
from repro_torch.interop import CGSTATE_ARRAYS, state_from_arrays
from repro_torch.matrices import laplace2d, laplace3d, matpde
from repro_torch.solvers import (GhostOperator, MatrixFreeOperator, cg,
                                 cg_finalize, cg_init, cg_step, make_operator,
                                 make_preconditioner, merge_columns,
                                 pipelined_cg,
                                 pipelined_cg_finalize, pipelined_cg_init,
                                 pipelined_cg_step)
from repro_torch.solvers import stepper

jcg = importlib.import_module("repro.solvers.cg")   # the package exports cg()

def _x64(on):
    return jax.enable_x64(True) if on else contextlib.nullcontext()


def case_study(dtype):
    """The port's and the JAX package's operators and right-hand side."""
    r, c, v, n = matpde(16, beta_c=0.0)
    kw = dict(C=16, sigma=32, w_align=4, dtype=dtype)
    b = np.random.default_rng(0).standard_normal((n, 2)).astype(dtype)
    A = from_coo(r, c, v, (n, n), device="cpu", **kw)
    return A, b, (r, c, v, n, kw)


def jax_cg(coo, b, *, x64, solver="cg", **kw):
    r, c, v, n, build = coo
    with _x64(x64):
        Aj = jfrom_coo(r, c, v, (n, n), **build)
        op = jmake_operator(Aj, impl="ref")
        fn = jcg.cg if solver == "cg" else jcg.pipelined_cg
        res = fn(op, Aj.permute(b), **kw)
        return (int(res.iters), np.asarray(res.converged),
                np.asarray(Aj.unpermute(res.x)))


def test_case_study_converges():
    A, b, _ = case_study(np.float32)
    assert A.beta > 0.5
    res = cg(make_operator(A), A.permute(b), tol=1e-6, maxiter=600)
    assert bool(res.converged.all())
    assert res.x.shape == (A.nrows_pad, 2) and res.x.dtype == torch.float32


@pytest.mark.parametrize("dtype,slack", [(np.float64, 0), (np.float32, 1)])
def test_case_study_iterations_match_jax(dtype, slack):
    A, b, coo = case_study(dtype)
    x64 = dtype == np.float64
    j_iters, j_conv, j_x = jax_cg(coo, b, x64=x64, tol=1e-6, maxiter=600)
    res = cg(make_operator(A), A.permute(b), tol=1e-6, maxiter=600)
    assert j_conv.all() and bool(res.converged.all())
    assert abs(res.iters - j_iters) <= slack
    x = A.unpermute(res.x).numpy()
    scale = np.abs(j_x).max()
    np.testing.assert_allclose(x, j_x, atol=(1e-10 if x64 else 1e-4) * scale)


def test_case_study_f64_iterations_exact():
    A, b, _ = case_study(np.float64)
    res = cg(make_operator(A), A.permute(b), tol=1e-6, maxiter=600)
    assert res.iters == 52


@pytest.mark.parametrize("k", [1, 7, 100, 700])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunked_equals_monolithic(dtype, k):
    A, b, _ = case_study(dtype)
    op = make_operator(A)
    bp = A.permute(b)
    mono = cg(op, bp, tol=1e-6, maxiter=600)
    st = cg_init(op, bp, tol=1e-6, maxiter=600)
    chunks = 0
    while st.it < st.maxiter and not bool(st.done.all()):
        st = cg_step(op, st, k)
        chunks += 1
    res = cg_finalize(st)
    assert chunks == -(-mono.iters // k)
    assert res.iters == mono.iters
    assert torch.equal(res.x, mono.x)
    assert torch.equal(res.resnorm, mono.resnorm)
    assert torch.equal(res.converged, mono.converged)


def test_maxiter_stops_the_stepper():
    A, b, _ = case_study(np.float32)
    res = cg(make_operator(A), A.permute(b), tol=1e-12, maxiter=9)
    assert res.iters == 9 and not bool(res.converged.any())
    st = cg_init(make_operator(A), A.permute(b), maxiter=9)
    assert cg_step(make_operator(A), st, 0) is st


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pipelined_cg_matches_jax(dtype):
    A, b, coo = case_study(dtype)
    x64 = dtype == np.float64
    # in float32 pipelined CG stalls above 1e-6 in both packages (its
    # recurrences drift from the true residual), so it is held at 1e-5
    tol = 1e-6 if x64 else 1e-5
    j_iters, j_conv, j_x = jax_cg(coo, b, x64=x64, solver="pipelined",
                                  tol=tol, maxiter=600)
    res = pipelined_cg(make_operator(A), A.permute(b), tol=tol, maxiter=600)
    assert j_conv.all() and bool(res.converged.all())
    assert abs(res.iters - j_iters) <= (0 if x64 else 1)
    x = A.unpermute(res.x).numpy()
    np.testing.assert_allclose(x, j_x, atol=(1e-9 if x64 else 1e-4)
                               * np.abs(j_x).max())
    # chunked pipelined CG equals the monolithic solve too
    op = make_operator(A)
    st = pipelined_cg_init(op, A.permute(b), tol=tol, maxiter=600)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = pipelined_cg_step(op, st, 5)
    assert torch.equal(pipelined_cg_finalize(st).x, res.x)


def test_zero_rhs_column_done_at_init():
    A, b, coo = case_study(np.float64)
    b = b.copy()
    b[:, 1] = 0.0
    op = make_operator(A)
    x0 = torch.ones(A.nrows_pad, 2, dtype=torch.float64)
    st = cg_init(op, A.permute(b), x0, tol=1e-6, maxiter=600)
    assert bool(st.done[1]) and not bool(st.done[0])
    assert torch.count_nonzero(st.x[:, 1]) == 0
    pst = pipelined_cg_init(op, A.permute(b), x0, tol=1e-6, maxiter=600)
    assert bool(pst.done[1])
    with _x64(True):
        r, c, v, n, build = coo
        Aj = jfrom_coo(r, c, v, (n, n), **build)
        jst = jcg.cg_init(jmake_operator(Aj), Aj.permute(b),
                          jnp.ones((A.nrows_pad, 2)), tol=1e-6, maxiter=600)
        np.testing.assert_array_equal(st.done.numpy(), np.asarray(jst.done))
        np.testing.assert_array_equal(st.tol2.numpy(), np.asarray(jst.tol2))
    res = cg(op, A.permute(b[:, 0]), tol=1e-6, maxiter=600)
    assert res.x.ndim == 1 and bool(res.converged)


def test_per_column_tolerance_matches_jax():
    A, b, coo = case_study(np.float64)
    tol = np.array([1e-3, 1e-8])
    with _x64(True):
        r, c, v, n, build = coo
        Aj = jfrom_coo(r, c, v, (n, n), **build)
        jres = jcg.cg(jmake_operator(Aj), Aj.permute(b), tol=jnp.asarray(tol),
                      maxiter=600)
        j_iters = int(jres.iters)
    res = cg(make_operator(A), A.permute(b), tol=tol, maxiter=600)
    assert res.iters == j_iters
    assert bool(res.converged.all())


@pytest.mark.parametrize("M,block", [("block_jacobi", False), (None, True)],
                         ids=["M", "block"])
def test_unported_modes_raise(M, block):
    """What still raises, as in the reference: a preconditioner with
    ``block=True`` (the block stepper is unpreconditioned) and with the
    pipelined stepper (no preconditioned variant), and the pipelined
    stepper's ``block=True``.  ``cg_init(M=...)`` returns a
    PrecondCGState, and a plain ``block=True`` a BlockCGState (see
    test_torch_block.py and test_torch_precond.py)."""
    A, b, _ = case_study(np.float32)
    op = make_operator(A)
    bp = A.permute(b)
    if M is not None:
        M = make_preconditioner(M, matrix=A)
        with pytest.raises(NotImplementedError, match="pipelined_cg"):
            pipelined_cg_init(op, bp, M=M)
        with pytest.raises(NotImplementedError, match="pipelined_cg"):
            pipelined_cg(op, bp, M=M)
        with pytest.raises(NotImplementedError, match="pipelined_cg"):
            pipelined_cg_step(op, pipelined_cg_init(op, bp), 3, M=M)
        with pytest.raises(NotImplementedError, match="block=True"):
            cg(op, bp, M=M, block=True)
        with pytest.raises(NotImplementedError, match="block=True"):
            cg_init(op, bp, M=M, block=True)
        assert type(cg_init(op, bp, M=M)).__name__ == "PrecondCGState"
    else:
        with pytest.raises(NotImplementedError):
            pipelined_cg_init(op, bp, block=block)
        M = make_preconditioner("block_jacobi", matrix=A)
        with pytest.raises(NotImplementedError):
            cg(op, bp, M=M, block=block)
        with pytest.raises(NotImplementedError):
            cg_init(op, bp, M=M, block=block)
        st = cg_init(op, bp, block=block)
        assert type(st).__name__ == "BlockCGState"
        with pytest.raises(ValueError, match="unpreconditioned"):
            cg_step(op, st, 3, M=M)


def test_state_from_jax_resumes_identically():
    """A JAX state carried across mid-solve, finished by the port, takes the
    reference's total iteration count and reaches its solution."""
    A, b, coo = case_study(np.float64)
    r, c, v, n, build = coo
    with _x64(True):
        Aj = jfrom_coo(r, c, v, (n, n), **build)
        jop = jmake_operator(Aj, impl="ref")
        jst = jcg.cg_step(jop, jcg.cg_init(jop, Aj.permute(b), tol=1e-6,
                                           maxiter=600), 20)
        arrays = {f: np.asarray(getattr(jst, f))
                  for f in CGSTATE_ARRAYS + ("it", "maxiter")}
        jfinal = jcg.cg_finalize(jcg.cg_step(jop, jst, 600))
        j_iters, j_x = int(jfinal.iters), np.asarray(jfinal.x)
    st = state_from_arrays(arrays, device="cpu")
    assert st.it == 20 and st.maxiter == 600
    res = cg_finalize(cg_step(make_operator(A), st, 600))
    assert res.iters == j_iters
    np.testing.assert_allclose(res.x.numpy(), j_x, atol=1e-10 * np.abs(j_x).max())
    with pytest.raises(ValueError, match="missing"):
        state_from_arrays({"x": arrays["x"]}, device="cpu")


def test_merge_columns_matches_jax():
    A, b, coo = case_study(np.float32)
    op = make_operator(A)
    old = cg_step(op, cg_init(op, A.permute(b), tol=1e-6), 4)
    fresh = cg_init(op, A.permute(b[:, ::-1].copy()), tol=1e-6)
    merged = merge_columns(old, fresh, [1])
    r, c, v, n, build = coo
    Aj = jfrom_coo(r, c, v, (n, n), **build)
    jop = jmake_operator(Aj)
    jold = jcg.cg_init(jop, Aj.permute(b), tol=1e-6)
    jfresh = jcg.cg_init(jop, Aj.permute(b[:, ::-1].copy()), tol=1e-6)
    jmerged = jstepper.merge_columns(jold, jfresh, [1])
    assert merged.it == 4 and int(jmerged.it) == 0
    assert torch.equal(merged.x[:, 0], old.x[:, 0])
    assert torch.equal(merged.x[:, 1], fresh.x[:, 1])
    np.testing.assert_array_equal(merged.done.numpy(),
                                  np.asarray(jmerged.done))
    both = stepper.merge_columns_masked(old, fresh, np.array([True, True]))
    assert torch.equal(both.r, fresh.r) and both.it == old.it

    class Coupled(tuple):
        BLOCK_COUPLED = True
    with pytest.raises(ValueError, match="column-spliced"):
        stepper.merge_columns_masked(Coupled(), Coupled(), [True])


@pytest.mark.parametrize("k,k_max", [(0, 8), (1, 8), (5, 8), (8, 8), (9, 8),
                                     (100, 64), (63, 64), (3, 1)])
def test_snap_chunk_matches_jax(k, k_max):
    assert stepper.snap_chunk(k, k_max) == jstepper.snap_chunk(k, k_max)


def test_snap_chunk_rejects_bad_cap():
    with pytest.raises(ValueError):
        stepper.snap_chunk(3, 0)
    stepper.clear_chunk_cache()


def test_matrix_free_operator_solves_identically():
    r, c, v, n = laplace2d(12)
    A = from_coo(r, c, v, (n, n), C=8, sigma=16, device="cpu")
    g = GhostOperator(A)
    mf = MatrixFreeOperator(g.mv, g.n, g.dtype)
    b = A.permute(np.random.default_rng(1).standard_normal((n, 3)))
    want = cg(g, b, tol=1e-9, maxiter=400)
    got = cg(mf, b, tol=1e-9, maxiter=400)
    assert got.iters == want.iters and torch.equal(got.x, want.x)
    assert mf.to_op_space(b) is b and mf.from_op_space(b) is b
    with pytest.raises(TypeError):
        make_operator("not a matrix")


@pytest.mark.parametrize("dtype,store,slack", [
    (np.float64, None, 0), (np.float32, None, 1), (np.float32, "bfloat16", 1)],
    ids=["f64", "f32", "bf16_store"])
def test_mixed_precision_cg_iterations_match_jax(dtype, store, slack):
    """The ``benchmarks/table_mixed_precision.py`` problem (laplace3d(12)
    scaled by e, one rhs, tol 1e-6) in both packages: float64 takes the
    reference's iteration count exactly, float32 and bfloat16 storage
    within one."""
    r, c, v, n = laplace3d(12)
    v = v * np.e
    build = dict(C=16, sigma=32, w_align=4, dtype=dtype, store_dtype=store)
    rng = np.random.default_rng(7)
    rng.standard_normal((n, 4))                  # the bench's SpMV operand
    b = rng.standard_normal(n).astype(dtype)
    A = from_coo(r, c, v, (n, n), device="cpu", **build)
    res = cg(make_operator(A), A.permute(b), tol=1e-6, maxiter=2000)
    with _x64(dtype == np.float64):
        Aj = jfrom_coo(r, c, v, (n, n), **build)
        jres = jcg.cg(jmake_operator(Aj), Aj.permute(b), tol=1e-6,
                      maxiter=2000)
        j_iters = int(jres.iters)
    assert bool(res.converged) and bool(jres.converged)
    assert abs(res.iters - j_iters) <= slack
