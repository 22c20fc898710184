"""The late-read ``run_chunk`` (``repro_torch.solvers.stepper``) against a
loop that reads ``done`` before every iteration.

``run_chunk`` enqueues iteration i+1 before it reads iteration i's
``done.all()`` and drops the speculative iteration when every column was
already done.  For every stepper (CG, PCG, pipelined CG, MINRES, PMINRES,
block CG, block MINRES) the states it returns must equal, bit for bit,
those of the plain loop below (the stopping test of the JAX package's
bounded ``while_loop``, evaluated on the host each iteration), and it must
count at most one discarded iteration per call.  On the CPU the flag is
read at once, but the loop takes the same speculative branch as on the
card, so these tests exercise it.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import execution, from_coo
from repro_torch.matrices import anisotropic_laplace2d
from repro_torch.solvers import (cg_init, cg_step, make_operator,
                                 make_preconditioner, minres_init,
                                 minres_step, pipelined_cg_init,
                                 pipelined_cg_step, run_chunk)
from repro_torch.solvers import block as tblock
from repro_torch.solvers.stepper import merge_columns_masked

tcg = importlib.import_module("repro_torch.solvers.cg")
tmin = importlib.import_module("repro_torch.solvers.minres")

NX, EPS, WIDTH, TOL, MAXITER = 12, 1e-2, 3, 1e-10, 2000


@pytest.fixture(scope="module")
def problem():
    """anisotropic_laplace2d(12), float64 on the CPU, a block-Jacobi
    preconditioner of 16-row blocks, and two right-hand sides of width 3."""
    r, c, v, n = anisotropic_laplace2d(NX, epsilon=EPS)
    A = from_coo(r, c, v, (n, n), C=16, sigma=1, dtype=np.float64,
                 device="cpu")
    rng = np.random.default_rng(5)
    b = A.permute(rng.standard_normal((n, WIDTH)))
    b2 = A.permute(rng.standard_normal((n, WIDTH)))
    return dict(A=A, op=make_operator(A), b=b, b2=b2,
                M=make_preconditioner("block_jacobi:16", matrix=A))


def _init(kind, P, b, **kw):
    M = P["M"] if kind in ("pcg", "pminres") else None
    block = kind.startswith("block")
    if kind == "pipelined_cg":
        return pipelined_cg_init(P["op"], b, **kw)
    if kind in ("cg", "pcg", "block_cg"):
        return cg_init(P["op"], b, M=M, block=block, **kw)
    return minres_init(P["op"], b, M=M, block=block, **kw)


#: solver -> (counter name, iteration body, takes M, public step)
SOLVERS = {
    "cg": ("cg", tcg._cg_body, False, cg_step),
    "pcg": ("cg_precond", tcg._cg_precond_body, True, cg_step),
    "pipelined_cg": ("pipelined_cg", tcg._pcg_body, False,
                     pipelined_cg_step),
    "minres": ("minres", tmin._minres_body, False, minres_step),
    "pminres": ("minres_precond", tmin._minres_precond_body, True,
                minres_step),
    "block_cg": ("block_cg", tblock.block_cg_body, False, cg_step),
    "block_minres": ("block_minres", tblock.block_minres_body, False,
                     minres_step),
}
COLUMN_SOLVERS = ["cg", "pcg", "pipelined_cg", "minres", "pminres"]


def eager_chunk(kind, P, state, k):
    """The reference loop: ``done`` read on the host before every
    iteration."""
    _, body, takes_m, _ = SOLVERS[kind]
    args = (P["M"],) if takes_m else ()
    i = 0
    while i < k and state.it < state.maxiter and not bool(state.done.all()):
        state = body(P["op"], *args, state)
        i += 1
    return state


def late_chunk(kind, P, state, k):
    """One public ``*_step`` call; returns the state and the iterations it
    discarded."""
    name, _, takes_m, step = SOLVERS[kind]
    before = execution.discarded_counts().get(name, 0)
    kw = {"M": P["M"]} if takes_m else {}
    out = step(P["op"], state, k, **kw)
    return out, execution.discarded_counts().get(name, 0) - before


def assert_same(got, want):
    assert type(got) is type(want)
    for field, g, w in zip(got._fields, got, want):
        if isinstance(g, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), field
        else:
            assert g == w, field


def _iterations(kind, P, **kw):
    """Iterations of the whole solve, by the reference loop."""
    st = eager_chunk(kind, P, _init(kind, P, P["b"], **kw), 10 ** 6)
    assert bool(st.done.all())
    return st.it


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_converges_inside_a_chunk(problem, kind):
    st0 = _init(kind, problem, problem["b"], tol=TOL, maxiter=MAXITER)
    n = _iterations(kind, problem, tol=TOL, maxiter=MAXITER)
    got, dropped = late_chunk(kind, problem, st0, n + 7)
    assert_same(got, eager_chunk(kind, problem, st0, n + 7))
    assert got.it == n and bool(got.done.all())
    assert dropped == 1


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_converges_at_k(problem, kind):
    """A chunk that ends at ``k`` just as the last column converges never
    speculates; the next call finds every column done on entry."""
    st0 = _init(kind, problem, problem["b"], tol=TOL, maxiter=MAXITER)
    n = _iterations(kind, problem, tol=TOL, maxiter=MAXITER)
    got, dropped = late_chunk(kind, problem, st0, n)
    assert_same(got, eager_chunk(kind, problem, st0, n))
    assert got.it == n and bool(got.done.all()) and dropped == 0
    again, dropped = late_chunk(kind, problem, got, 5)
    assert_same(again, got)
    assert dropped == 1


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_stops_at_maxiter(problem, kind):
    n = _iterations(kind, problem, tol=TOL, maxiter=MAXITER)
    cap = n // 2
    st0 = _init(kind, problem, problem["b"], tol=TOL, maxiter=cap)
    got, dropped = late_chunk(kind, problem, st0, 10 * n)
    assert_same(got, eager_chunk(kind, problem, st0, 10 * n))
    assert got.it == cap and not bool(got.done.all()) and dropped == 0
    same, dropped = late_chunk(kind, problem, got, 3)
    assert_same(same, got)
    assert dropped == 0


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_every_column_done_on_entry(problem, kind):
    """A zero right-hand side is done at init: the speculative iteration
    runs on it without raising and is dropped."""
    zero = torch.zeros_like(problem["b"])
    st0 = _init(kind, problem, zero, tol=TOL, maxiter=MAXITER)
    assert bool(st0.done.all())
    got, dropped = late_chunk(kind, problem, st0, 4)
    assert_same(got, st0)
    assert dropped == 1


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_chunks_of_one(problem, kind):
    """``k=1`` chunks under a caller that checks ``done`` between calls
    equal the reference step by step and never waste an iteration."""
    st = _init(kind, problem, problem["b"], tol=TOL, maxiter=MAXITER)
    calls = 0
    while st.it < st.maxiter and not bool(st.done.all()):
        want = eager_chunk(kind, problem, st, 1)
        st, dropped = late_chunk(kind, problem, st, 1)
        assert_same(st, want)
        assert dropped == 0
        calls += 1
    assert calls == _iterations(kind, problem, tol=TOL, maxiter=MAXITER)


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_uneven_chunks_equal_monolithic(problem, kind):
    st0 = _init(kind, problem, problem["b"], tol=TOL, maxiter=MAXITER)
    whole = eager_chunk(kind, problem, st0, 10 ** 6)
    st, sizes, total = st0, (1, 2, 3, 5, 8, 13), 0
    for j in range(10 ** 4):
        if bool(st.done.all()):
            break
        st, dropped = late_chunk(kind, problem, st, sizes[j % len(sizes)])
        assert dropped in (0, 1)
        total += dropped
    assert_same(st, whole)
    assert total <= 1


@pytest.mark.parametrize("kind", COLUMN_SOLVERS)
def test_refill_through_merge_columns_masked(problem, kind):
    """Columns of different tolerances finish at different iterations;
    the finished ones are refilled with fresh columns of another
    right-hand side, and the late-read loop follows the reference through
    the refill to the end."""
    tol = torch.tensor([1e-3, 1e-10, 1e-6], dtype=torch.float64)
    st_late = st_eager = _init(kind, problem, problem["b"], tol=tol,
                               maxiter=MAXITER)
    refilled = False
    for _ in range(10 ** 4):
        if bool(st_late.done.all()) and refilled:
            break
        if bool(st_late.done.any()) and not refilled:
            fresh = _init(kind, problem, problem["b2"], tol=1e-8,
                          maxiter=MAXITER)
            mask = st_late.done.clone()
            st_late = merge_columns_masked(st_late, fresh, mask)
            st_eager = merge_columns_masked(st_eager, fresh, mask)
            refilled = True
        st_eager = eager_chunk(kind, problem, st_eager, 4)
        st_late, dropped = late_chunk(kind, problem, st_late, 4)
        assert dropped in (0, 1)
        assert_same(st_late, st_eager)
    assert refilled and bool(st_late.done.all())


def test_run_chunk_counts_by_name_and_reset_clears(problem):
    execution.reset_launch_counts()
    st0 = _init("cg", problem, torch.zeros_like(problem["b"]), tol=TOL,
                maxiter=MAXITER)
    out = run_chunk(problem["op"], "my_solver", 3, st0, tcg._cg_body)
    assert out is st0
    assert execution.discarded_counts()["my_solver"] == 1
    assert run_chunk(problem["op"], "my_solver", 0, st0,
                     tcg._cg_body) is st0
    assert execution.discarded_counts()["my_solver"] == 1
    execution.reset_launch_counts()
    assert execution.discarded_counts()["my_solver"] == 0
