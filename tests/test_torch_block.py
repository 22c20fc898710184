"""Parity of the port's block-Krylov steppers (``repro_torch.solvers.block``:
BCGrQ block CG and block MINRES, through ``cg``/``minres(block=True)``)
with the JAX package, on the CPU.

* The sweep counts of the JAX package's artifact (``BENCH_2026-08-08.json``,
  rows ``block_krylov_*``: anisotropic Laplacian 32x32, epsilon 1e-2,
  width 16, float32) are reached exactly.
* float64 block CG and block MINRES take exactly the JAX package's
  iteration counts (the JAX side under ``jax.enable_x64``); the iterates
  agree to rtol 1e-8 of the largest entry (the two sum the Grams in other
  orders, and the tolerance 1e-10 solves leave that much freedom).
* float32 counts agree within one iteration (summation order).
* Eigenvectors differ in sign between the packages (``eigh``), so only
  iterates and counts are compared, never the bases.
"""
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.solvers import make_operator as jmake_operator  # noqa: E402
from repro_torch.core import from_coo, to_dense  # noqa: E402
from repro_torch.interop import state_from_arrays  # noqa: E402
from repro_torch.matrices import anisotropic_laplace2d  # noqa: E402
from repro_torch.solvers import (BlockCGState, BlockMinresState, CGState,  # noqa: E402
                                 MinresState, cg, cg_finalize, cg_init,
                                 cg_step, make_operator, minres,
                                 minres_finalize, minres_init, minres_step)
from repro_torch.solvers import stepper  # noqa: E402

jcg = importlib.import_module("repro.solvers.cg")
jminres = importlib.import_module("repro.solvers.minres")
REPO = Path(__file__).resolve().parents[1]
PORT = {"cg": (cg, cg_init, cg_step, cg_finalize),
        "minres": (minres, minres_init, minres_step, minres_finalize)}
JAX = {"cg": (jcg.cg, jcg.cg_init, jcg.cg_step, jcg.cg_finalize),
       "minres": (jminres.minres, jminres.minres_init, jminres.minres_step,
                  jminres.minres_finalize)}


def problem(nx, width, dtype, seed=7):
    """The anisotropic Laplacian of the block-Krylov table and its rhs, for
    both packages (COO and build arguments for the JAX side)."""
    r, c, v, n = anisotropic_laplace2d(nx, epsilon=1e-2)
    kw = dict(C=16, sigma=1, w_align=4, dtype=dtype)
    A = from_coo(r, c, v, (n, n), device="cpu", **kw)
    b = np.random.default_rng(seed).standard_normal((n, width)).astype(dtype)
    return A, b, (r, c, v, n, kw)


def jax_op(coo):
    r, c, v, n, kw = coo
    Aj = jfrom_coo(r, c, v, (n, n), **kw)
    return Aj, jmake_operator(Aj, impl="ref")


def artifact_counts(solver):
    """(column sweeps, block sweeps) of the JAX package's artifact row."""
    rows = json.loads((REPO / "BENCH_2026-08-08.json").read_text())
    row = next(r for r in rows["benches"]["table_block_krylov"]
               if r["name"] == f"block_krylov_{solver}")
    fields = dict(kv.split("=") for kv in row["derived"].split(";"))
    return int(fields["column_sweeps"]), int(fields["block_sweeps"])


@pytest.mark.parametrize("solver,tol", [("cg", 1e-6), ("minres", 1e-5)])
def test_sweep_counts_of_the_reference_artifact(solver, tol):
    col_want, blk_want = artifact_counts(solver)
    assert (col_want, blk_want) == {"cg": (140, 65),
                                    "minres": (108, 63)}[solver]
    A, b, _ = problem(32, 16, np.float32)
    fn = PORT[solver][0]
    op = make_operator(A)
    bp = A.permute(b)
    col = fn(op, bp, tol=tol, maxiter=4000)
    blk = fn(op, bp, tol=tol, maxiter=4000, block=True)
    assert bool(col.converged.all()) and bool(blk.converged.all())
    assert (col.iters, blk.iters) == (col_want, blk_want)


@pytest.mark.parametrize("solver", ["cg", "minres"])
@pytest.mark.parametrize("dtype,tol,slack", [(np.float64, 1e-10, 0),
                                             (np.float32, 1e-5, 1)])
def test_block_solve_matches_jax(solver, dtype, tol, slack):
    A, b, coo = problem(16, 8, dtype)
    with jax.enable_x64(dtype == np.float64):
        Aj, jop = jax_op(coo)
        jres = JAX[solver][0](jop, Aj.permute(b), tol=tol, maxiter=400,
                              block=True)
        j_iters, j_x = int(jres.iters), np.asarray(Aj.unpermute(jres.x))
        assert bool(np.all(np.asarray(jres.converged)))
    res = PORT[solver][0](make_operator(A), A.permute(b), tol=tol,
                          maxiter=400, block=True)
    assert bool(res.converged.all())
    assert abs(res.iters - j_iters) <= slack
    x = A.unpermute(res.x).numpy()
    rtol = 1e-8 if dtype == np.float64 else 1e-3
    np.testing.assert_allclose(x, j_x, atol=rtol * np.abs(j_x).max())


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_block_solve_is_a_solution(solver):
    """The true residual of every column meets the tolerance, and the block
    solve takes no more iterations than the column solve."""
    A, b, _ = problem(16, 8, np.float64)
    Ad = torch.from_numpy(to_dense(A))
    op = make_operator(A)
    bp = A.permute(b)
    col = PORT[solver][0](op, bp, tol=1e-10, maxiter=400)
    blk = PORT[solver][0](op, bp, tol=1e-10, maxiter=400, block=True)
    assert blk.iters <= col.iters
    X = A.unpermute(blk.x)
    B = torch.from_numpy(b)
    rel = (Ad @ X - B).norm(dim=0) / B.norm(dim=0)
    assert float(rel.max()) <= 1e-9


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_width1_block_is_the_plain_stepper(solver):
    """A one-column ``block=True`` call returns the plain state type in
    both packages and equals the column solve bit for bit, with the JAX
    package's iteration count (this call raised in the port before)."""
    fn, init, _, _ = PORT[solver]
    plain = CGState if solver == "cg" else MinresState
    A, b, coo = problem(16, 1, np.float64)
    op = make_operator(A)
    bp = A.permute(b)
    assert type(init(op, bp, tol=1e-8, block=True)) is plain
    ref = fn(op, bp, tol=1e-8, maxiter=400)
    blk = fn(op, bp, tol=1e-8, maxiter=400, block=True)
    assert torch.equal(ref.x, blk.x) and ref.iters == blk.iters
    with jax.enable_x64(True):
        Aj, jop = jax_op(coo)
        jst = JAX[solver][1](jop, Aj.permute(b), tol=1e-8, block=True)
        assert type(jst).__name__ == plain.__name__
        jblk = JAX[solver][0](jop, Aj.permute(b), tol=1e-8, maxiter=400,
                              block=True)
        jref = JAX[solver][0](jop, Aj.permute(b), tol=1e-8, maxiter=400)
        assert np.array_equal(np.asarray(jblk.x), np.asarray(jref.x))
        assert int(jblk.iters) == blk.iters


@pytest.mark.parametrize("k", [1, 7, 100])
@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_block_chunked_equals_monolithic(solver, k):
    _, init, step, _ = PORT[solver]
    A, b, _ = problem(16, 3, np.float32)
    op = make_operator(A)
    bp = A.permute(b)
    st = step(op, init(op, bp, tol=1e-6, maxiter=100, block=True), 200)
    st2 = init(op, bp, tol=1e-6, maxiter=100, block=True)
    for _ in range(100 // k + 1):
        st2 = step(op, st2, k)
    assert isinstance(st, (BlockCGState, BlockMinresState))
    assert torch.equal(st.x, st2.x) and st.it == st2.it


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_jax_block_state_continues_in_the_port(solver):
    """A JAX block state after 10 steps, carried across through
    ``interop.state_from_arrays``, is finished by the port in the JAX
    package's total iteration count and at its solution."""
    A, b, coo = problem(16, 4, np.float64)
    _, jinit, jstep, jfin = JAX[solver]
    with jax.enable_x64(True):
        Aj, jop = jax_op(coo)
        jst = jstep(jop, jinit(jop, Aj.permute(b), tol=1e-10, maxiter=400,
                               block=True), 10)
        arrays = {f: np.asarray(getattr(jst, f)) for f in jst._fields}
        jfinal = jfin(jstep(jop, jst, 400))
        j_iters, j_x = int(jfinal.iters), np.asarray(jfinal.x)
    st = state_from_arrays(arrays, device="cpu")
    want = BlockCGState if solver == "cg" else BlockMinresState
    assert type(st) is want and st.it == 10
    _, _, step, fin = PORT[solver]
    res = fin(step(make_operator(A), st, 400))
    assert res.iters == j_iters
    np.testing.assert_allclose(res.x.numpy(), j_x,
                               atol=1e-8 * np.abs(j_x).max())


def test_merge_columns_refuses_block_states():
    A, b, _ = problem(8, 3, np.float32)
    op = make_operator(A)
    bp = A.permute(b)
    for init in (cg_init, minres_init):
        st = init(op, bp, tol=1e-6, block=True)
        with pytest.raises(ValueError, match="column-spliced"):
            stepper.merge_columns(st, st, [0])


def test_preconditioned_block_raises():
    A, b, _ = problem(8, 3, np.float32)
    op = make_operator(A)
    bp = A.permute(b)
    for fn in (cg, minres, cg_init, minres_init):
        with pytest.raises(NotImplementedError, match="block-Jacobi"):
            fn(op, bp, M=object(), block=True)


def test_rank_deficient_rhs_deflates():
    """Duplicate rhs columns make the block rank-deficient from the first
    step; SVQB deflates the copies and every column still converges, with
    the duplicated columns solved identically, as in the JAX package."""
    A, b, coo = problem(16, 2, np.float64)
    b = np.concatenate([b, b[:, :1], 2.0 * b[:, 1:]], axis=1)
    res = cg(make_operator(A), A.permute(b), tol=1e-10, maxiter=400,
             block=True)
    assert bool(res.converged.all())
    x = res.x
    np.testing.assert_allclose(x[:, 2].numpy(), x[:, 0].numpy(),
                               atol=1e-8 * float(x.abs().max()))
    np.testing.assert_allclose(x[:, 3].numpy(), 2.0 * x[:, 1].numpy(),
                               atol=1e-8 * float(x.abs().max()))
    with jax.enable_x64(True):
        Aj, jop = jax_op(coo)
        jres = jcg.cg(jop, Aj.permute(b), tol=1e-10, maxiter=400, block=True)
        assert int(jres.iters) == res.iters


def test_zero_rhs_column_done_at_init():
    A, b, _ = problem(8, 3, np.float64)
    b[:, 1] = 0.0
    op = make_operator(A)
    for init in (cg_init, minres_init):
        st = init(op, A.permute(b), tol=1e-8, block=True)
        assert bool(st.done[1]) and not bool(st.done[0])
        assert torch.count_nonzero(st.x[:, 1]) == 0
    res = cg(op, A.permute(b), tol=1e-8, maxiter=400, block=True)
    assert bool(res.converged.all())
    assert torch.count_nonzero(res.x[:, 1]) == 0


def test_per_column_tolerance():
    A, b, coo = problem(16, 4, np.float64)
    tol = np.array([1e-3, 1e-10, 1e-6, 1e-8])
    res = cg(make_operator(A), A.permute(b), tol=tol, maxiter=400,
             block=True)
    with jax.enable_x64(True):
        Aj, jop = jax_op(coo)
        jres = jcg.cg(jop, Aj.permute(b), tol=jnp.asarray(tol), maxiter=400,
                      block=True)
        assert int(jres.iters) == res.iters
    assert bool(res.converged.all())
