"""Parity of the port's preconditioners and preconditioned steppers
(``repro_torch.solvers.precond``, ``cg(M=)``, ``minres(M=)``, kernel B4
behind ``kernels/ops.py:block_jacobi_apply``) with the JAX package's.

The same numpy inputs go through both packages on the CPU:
* block extraction and factorization run on the host in numpy in both, so
  their blocks must be bit-identical;
* ``block_jacobi_apply`` against the JAX op (its Pallas kernel in
  interpret mode): max |port - JAX| / max |JAX| at most 1e-13 in float64,
  1e-6 in float32 and one unit of the output's last place for
  bfloat16/float16 (2^-7, 2^-10): the two sum a row in other orders;
* iteration counts of preconditioned CG and MINRES must be equal, on the
  JAX benchmark's problem (``benchmarks/table_precond.py``:
  anisotropic_laplace2d(48), eps 1e-2, C=16, sigma=1, w_align=4, float32,
  tol 1e-6), where the JAX package's record is 210 / 21 / 58 iterations
  for plain / block_jacobi:48 / chebyshev:4 (``BENCH_2026-08-08.json``);
  float64 MINRES solutions agree to 1e-9 of their largest entry.

The ``gpu``-marked tests hold the CUDA kernel against its plain version
on the card and run a preconditioned solve there; they skip here.
"""
import gc
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core import from_dense as jfrom_dense  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.solvers import lanczos_extrema as jlanczos_extrema  # noqa: E402
from repro.solvers import make_operator as jmake_operator  # noqa: E402
from repro.solvers import precond as jprecond  # noqa: E402
from repro_torch.core import execution, from_coo, from_dense  # noqa: E402
from repro_torch.interop import state_from_arrays, tensor_from_array  # noqa: E402
from repro_torch.kernels.block_diag import MAX_BS, block_diag_cuda  # noqa: E402
from repro_torch.kernels.ops import block_jacobi_apply  # noqa: E402
from repro_torch.kernels.ref import block_diag_matmul_ref  # noqa: E402
from repro_torch.matrices import anisotropic_laplace2d  # noqa: E402
from repro_torch.solvers import (BlockJacobiPreconditioner,  # noqa: E402
                                 ChebyshevPreconditioner, PrecondCGState,
                                 PrecondMinresState, cg, cg_finalize,
                                 cg_init, cg_step, extract_block_diag,
                                 factorize_blocks, make_operator,
                                 make_preconditioner, minres,
                                 minres_finalize, minres_init, minres_step,
                                 parse_precond_spec, run_chunk)

jcg = importlib.import_module("repro.solvers.cg")
tcg = importlib.import_module("repro_torch.solvers.cg")
jmin = importlib.import_module("repro.solvers.minres")
ml_dtypes = pytest.importorskip("ml_dtypes")

DTYPES = {"float64": np.float64, "float32": np.float32,
          "bfloat16": ml_dtypes.bfloat16, "float16": np.float16}
APPLY_TOL = {"float64": 1e-13, "float32": 1e-6, "bfloat16": 2.0 ** -7,
             "float16": 2.0 ** -10}
#: the JAX benchmark's problem and its recorded iteration counts
NX, EPS, TOL, MAXITER = 48, 1e-2, 1e-6, 4000
RECORD = {"plain": 210, "block_jacobi:48": 21, "chebyshev:4": 58}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    diff = np.abs(got - want).max() if want.size else 0.0
    return diff / scale if scale else diff


@pytest.fixture(scope="module")
def bench():
    """Both packages' operators on table_precond.py's problem, its
    right-hand side, and the spectrum the JAX registry gives Chebyshev
    (one Lanczos run, seed 0), passed to both packages."""
    r, c, v, n = anisotropic_laplace2d(NX, epsilon=EPS)
    kw = dict(C=16, sigma=1, w_align=4, dtype=np.float32)
    b = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    Aj = jfrom_coo(r, c, v, (n, n), **kw)
    jop = jmake_operator(Aj, impl="ref")
    A = from_coo(r, c, v, (n, n), device="cpu", **kw)
    return dict(A=A, op=make_operator(A), Aj=Aj, jop=jop, b=b,
                spectrum=jlanczos_extrema(jop), coo=(r, c, v, n))


# ----------------------------------------------------- block extraction
@pytest.mark.parametrize("sigma,bs", [(1, 4), (1, 16), (16, 8), (32, 16),
                                      (32, 4)])
def test_extract_block_diag_bit_identical(sigma, bs):
    rng = np.random.default_rng(sigma * 100 + bs)
    n = 55
    a = ((rng.random((n, n)) < 0.15)
         * rng.standard_normal((n, n))).astype(np.float64)
    kw = dict(C=16, sigma=sigma, w_align=2, dtype=np.float64)
    got = extract_block_diag(from_dense(a, device="cpu", **kw), bs)
    with jax.enable_x64(True):
        want = jprecond.extract_block_diag(jfrom_dense(a, **kw), bs)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_extract_explicit_zeros_and_empty_rows():
    # row 2 empty; an explicit zero on the diagonal of row 1
    r, c = np.array([0, 0, 1, 3]), np.array([0, 1, 1, 3])
    v = np.array([2.0, 1.0, 0.0, 5.0])
    got = extract_block_diag(from_coo(r, c, v, (4, 4), C=2, sigma=1,
                                      device="cpu"), 2)
    with jax.enable_x64(True):
        want = jprecond.extract_block_diag(jfrom_coo(r, c, v, (4, 4), C=2,
                                                     sigma=1), 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[[2.0, 1.0], [0.0, 0.0]],
                                        [[0.0, 0.0], [0.0, 5.0]]])


def test_extract_unpermuted_columns():
    """An external row permutation (permuted_cols=False): columns map
    through iperm during extraction."""
    rng = np.random.default_rng(2)
    n = 16
    a = np.diag(rng.random(n) + 1.0)
    a[0, 1] = a[1, 0] = 0.5
    r, c = np.nonzero(a)
    ext = np.arange(n, dtype=np.int64)[::-1].copy()
    A = from_coo(r, c, a[r, c], (n, n), C=4, row_perm=ext, device="cpu")
    assert not A.permuted_cols
    with jax.enable_x64(True):
        Aj = jfrom_coo(r, c, a[r, c], (n, n), C=4, row_perm=ext)
        want = jprecond.extract_block_diag(Aj, 4)
    np.testing.assert_array_equal(extract_block_diag(A, 4), want)


@pytest.mark.parametrize("store", [torch.bfloat16, torch.float16])
def test_extract_narrow_storage_bit_identical(store):
    rng = np.random.default_rng(4)
    n = 40
    a = ((rng.random((n, n)) < 0.2) * rng.standard_normal((n, n)))
    kw = dict(C=8, sigma=16, dtype=np.float32)
    A = from_dense(a, device="cpu", store_dtype=store, **kw)
    Aj = jfrom_dense(a, store_dtype=str(store)[6:], **kw)
    np.testing.assert_array_equal(extract_block_diag(A, 8),
                                  jprecond.extract_block_diag(Aj, 8))


def test_extract_refuses_bad_block_sizes():
    A = from_coo([0, 1], [0, 1], [1.0, 2.0], (2, 2), C=2, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        extract_block_diag(A, 3)
    with pytest.raises(ValueError, match="square"):
        extract_block_diag(from_coo([0], [0], [1.0], (4, 6), C=2,
                                    device="cpu"), 2)


# --------------------------------------------------------- factorization
def _stacks():
    rng = np.random.default_rng(7)
    g = rng.standard_normal((5, 6, 6))
    spd = g @ g.transpose(0, 2, 1) + 6 * np.eye(6)
    indef = spd.copy()
    indef[:, 0, 0] = -40.0
    singular = spd.copy()
    singular[1] = 0.0
    singular[2, 3] = singular[2, 2]                 # two equal rows
    singular[2, :, 3] = singular[2, :, 2]
    h = g + 1j * rng.standard_normal((5, 6, 6))
    herm = h @ h.conj().transpose(0, 2, 1) + 6 * np.eye(6)
    return {"spd": (spd, False), "indefinite": (indef, False),
            "singular": (singular, False), "absolute": (indef, True),
            "complex_hermitian": (herm, False),
            "complex_absolute": (herm - 20 * np.eye(6), True)}


@pytest.mark.parametrize("case", list(_stacks()))
def test_factorize_blocks_equals_the_reference(case):
    blocks, absolute = _stacks()[case]
    got = factorize_blocks(blocks, absolute=absolute)
    want = jprecond.factorize_blocks(blocks, absolute=absolute)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_block_jacobi_inverse_blocks_match_the_reference(bench):
    M = BlockJacobiPreconditioner(bench["A"], block_size=NX)
    Mj = jprecond.BlockJacobiPreconditioner(bench["Aj"], block_size=NX)
    assert M.inv_blocks.dtype == torch.float32 and M.block_size == NX
    np.testing.assert_array_equal(M.inv_blocks.numpy(),
                                  np.asarray(Mj.inv_blocks))
    assert "bs=48" in repr(M)


def test_block_jacobi_needs_sellcs():
    with pytest.raises(TypeError, match="SELL-C-sigma"):
        BlockJacobiPreconditioner(np.eye(4), block_size=2)


# ------------------------------------------------ block_jacobi_apply (B4)
@pytest.mark.parametrize("nb,bs,b,one_d", [(8, 16, 3, False),
                                           (5, 8, 1, False), (5, 8, 1, True),
                                           (17, 4, 5, False),
                                           (3, 48, 4, False)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_jacobi_apply_matches_jax(dtype, nb, bs, b, one_d):
    rng = np.random.default_rng(nb * bs + b)
    blocks = rng.standard_normal((nb, bs, bs)).astype(DTYPES[dtype])
    x = rng.standard_normal((nb * bs, b)).astype(DTYPES[dtype])
    if one_d:
        x = x[:, 0]
    with jax.enable_x64(dtype == "float64"):
        jy = jops.block_jacobi_apply(jnp.asarray(blocks), jnp.asarray(x))
        jdt, jy = jy.dtype.name, np.asarray(jy, np.float64)
    y = block_jacobi_apply(tensor_from_array(blocks, "cpu"),
                           tensor_from_array(x, "cpu"))
    assert str(y.dtype)[6:] == jdt == dtype
    assert _rel(y.double().numpy(), jy) <= APPLY_TOL[dtype]


@pytest.mark.parametrize("bd,xd", [("float32", "float64"),
                                   ("bfloat16", "float32"),
                                   ("float16", "bfloat16")])
def test_block_jacobi_apply_mixed_dtypes(bd, xd):
    """Blocks and x may differ in dtype: the result has
    ``result_type(blocks, x)``, as in the Pallas kernel."""
    rng = np.random.default_rng(9)
    blocks = rng.standard_normal((6, 8, 8)).astype(DTYPES[bd])
    x = rng.standard_normal((48, 3)).astype(DTYPES[xd])
    with jax.enable_x64("float64" in (bd, xd)):
        jy = jops.block_jacobi_apply(jnp.asarray(blocks), jnp.asarray(x))
        jdt, jy = jy.dtype.name, np.asarray(jy, np.float64)
    y = block_jacobi_apply(tensor_from_array(blocks, "cpu"),
                           tensor_from_array(x, "cpu"))
    assert str(y.dtype)[6:] == jdt
    assert _rel(y.double().numpy(), jy) <= APPLY_TOL[jdt]


def test_block_jacobi_apply_complex_on_the_cpu():
    rng = np.random.default_rng(10)
    blocks = (rng.standard_normal((4, 4, 4))
              + 1j * rng.standard_normal((4, 4, 4)))
    x = rng.standard_normal((16, 2)) + 1j * rng.standard_normal((16, 2))
    with jax.enable_x64(True):
        jy = np.asarray(jops.block_jacobi_apply(jnp.asarray(blocks),
                                                jnp.asarray(x)))
    y = block_jacobi_apply(torch.from_numpy(blocks), torch.from_numpy(x))
    assert y.dtype == torch.complex128
    assert np.abs(y.numpy() - jy).max() <= 1e-13 * np.abs(jy).max()


def test_block_jacobi_apply_refuses_bad_shapes():
    with pytest.raises(ValueError, match="nblocks"):
        block_jacobi_apply(torch.zeros(2, 3, 3), torch.zeros(7, 1))
    with pytest.raises(ValueError, match="bs, bs"):
        block_jacobi_apply(torch.zeros(2, 3, 4), torch.zeros(6, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        block_diag_cuda(torch.zeros(2, 3, 3), torch.zeros(6, 1))


# ------------------------------------------------------------ PCG parity
def _precond(name, bench, jax_side):
    if name == "plain":
        return None
    if jax_side:
        return jprecond.make_preconditioner(name, matrix=bench["Aj"],
                                            op=bench["jop"],
                                            spectrum=bench["spectrum"])
    return make_preconditioner(name, matrix=bench["A"], op=bench["op"],
                               spectrum=bench["spectrum"])


@pytest.mark.parametrize("name", list(RECORD))
def test_pcg_iterations_equal_the_reference(bench, name):
    """Equal counts in both packages, and both reproduce the JAX
    package's record (210 / 21 / 58)."""
    A, Aj = bench["A"], bench["Aj"]
    jres = jcg.cg(bench["jop"], Aj.permute(bench["b"]), tol=TOL,
                  maxiter=MAXITER, M=_precond(name, bench, True))
    M = _precond(name, bench, False)
    execution.reset_launch_counts()
    res = cg(bench["op"], A.permute(bench["b"]), tol=TOL, maxiter=MAXITER,
             M=M)
    assert bool(res.converged) and bool(jres.converged)
    assert res.iters == int(jres.iters) == RECORD[name]
    if M is not None:
        assert isinstance(M, (BlockJacobiPreconditioner,
                              ChebyshevPreconditioner))
    # the plain versions on the CPU launch nothing
    assert not any(execution.launch_counts().values())


def test_pcg_solution_and_true_residual(bench):
    A = bench["A"]
    r, c, v, n = bench["coo"]
    M = make_preconditioner(f"block_jacobi:{NX}", matrix=A)
    res = cg(bench["op"], A.permute(bench["b"]), tol=TOL, maxiter=MAXITER,
             M=M)
    x = A.unpermute(res.x).double().numpy()
    Ax = np.zeros(n)
    np.add.at(Ax, r, np.asarray(v, np.float64) * x[c])
    b = bench["b"].astype(np.float64)
    assert np.linalg.norm(b - Ax) / np.linalg.norm(b) <= 10 * TOL
    assert float(res.resnorm) <= TOL * np.linalg.norm(b) * 1.01


@pytest.mark.parametrize("name,k", [("block_jacobi:16", 1),
                                    ("block_jacobi:16", 7),
                                    ("chebyshev:3", 5)])
def test_pcg_chunked_equals_monolithic(bench, name, k):
    A, op = bench["A"], bench["op"]
    b = A.permute(np.random.default_rng(3).standard_normal(
        (A.nrows, 2)).astype(np.float32))
    M = _precond(name, bench, False)
    ref = cg(op, b, tol=TOL, maxiter=300, M=M)
    st = cg_init(op, b, tol=TOL, maxiter=300, M=M)
    assert isinstance(st, PrecondCGState)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = cg_step(op, st, k, M=M)
    res = cg_finalize(st)
    assert res.iters == ref.iters
    assert torch.equal(res.x, ref.x) and torch.equal(res.resnorm, ref.resnorm)


def test_run_chunk_hands_the_preconditioner_to_the_body(bench):
    """The port's ``run_chunk`` passes ``M`` to the body as an argument;
    it has no ``extra_key=`` (the JAX package's key of its compiled-chunk
    cache), since it compiles and caches nothing."""
    A, op = bench["A"], bench["op"]
    b = A.permute(np.random.default_rng(4).standard_normal(
        (A.nrows, 1)).astype(np.float32))
    M = _precond("block_jacobi:16", bench, False)
    st = cg_init(op, b, tol=TOL, maxiter=300, M=M)
    seen = []

    def body(o, m, s):
        seen.append(m)
        return tcg._cg_precond_body(o, m, s)

    st2 = run_chunk(op, "cg_precond", 3, st, body, M)
    assert seen == [M, M, M] and st2.it == st.it + 3
    ref = cg_step(op, st, 3, M=M)
    assert torch.equal(st2.x, ref.x) and torch.equal(st2.rz, ref.rz)
    with pytest.raises(TypeError):
        run_chunk(op, "cg_precond", 1, st, body, extra_key=M)


def test_pcg_state_from_jax_continues_identically(bench):
    """A JAX PrecondCGState carried across mid-solve, finished by the
    port with its own M over the same blocks, takes the reference's total
    iteration count and reaches its solution."""
    A, Aj = bench["A"], bench["Aj"]
    Mj = _precond("block_jacobi:48", bench, True)
    jst = jcg.cg_step(bench["jop"], jcg.cg_init(
        bench["jop"], Aj.permute(bench["b"]), tol=TOL, maxiter=MAXITER,
        M=Mj), 8, M=Mj)
    arrays = {f: np.asarray(getattr(jst, f)) for f in jst._fields}
    jfinal = jcg.cg_finalize(jcg.cg_step(bench["jop"], jst, MAXITER, M=Mj))
    st = state_from_arrays(arrays, device="cpu")
    assert type(st) is PrecondCGState and st.it == 8
    M = _precond("block_jacobi:48", bench, False)
    res = cg_finalize(cg_step(bench["op"], st, MAXITER, M=M))
    assert res.iters == int(jfinal.iters)
    jx = np.asarray(jfinal.x)
    assert _rel(res.x.numpy(), jx) <= 1e-5


def test_pcg_state_and_M_must_agree(bench):
    A, op = bench["A"], bench["op"]
    b = A.permute(bench["b"])
    M = _precond("block_jacobi:16", bench, False)
    with pytest.raises(ValueError, match="with a preconditioner"):
        cg_step(op, cg_init(op, b, M=M), 3)
    with pytest.raises(ValueError, match="without a preconditioner"):
        cg_step(op, cg_init(op, b), 3, M=M)


def test_complex_hermitian_pcg_matches_jax():
    """Complex blocks stay complex (Hermitian Cholesky); PCG over them
    takes the reference's iteration count."""
    rng = np.random.default_rng(12)
    n = 32
    B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = B @ B.conj().T + n * np.eye(n)
    r, c = np.nonzero(H)
    rhs = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    kw = dict(C=8, sigma=1, dtype=np.complex128)
    with jax.enable_x64(True):
        Aj = jfrom_coo(r, c, H[r, c], (n, n), **kw)
        Mj = jprecond.BlockJacobiPreconditioner(Aj, block_size=8)
        jres = jcg.cg(jmake_operator(Aj, impl="ref"), Aj.permute(rhs),
                      tol=1e-10, maxiter=200, M=Mj)
        j_iters, jx = int(jres.iters), np.asarray(Aj.unpermute(jres.x))
    A = from_coo(r, c, H[r, c], (n, n), device="cpu", **kw)
    M = BlockJacobiPreconditioner(A, block_size=8)
    assert M.inv_blocks.dtype == torch.complex128
    res = cg(make_operator(A), A.permute(rhs), tol=1e-10, maxiter=200, M=M)
    assert bool(res.converged) and res.iters == j_iters
    x = A.unpermute(res.x).numpy()
    assert np.abs(x - jx).max() <= 1e-9 * np.abs(jx).max()


# ---------------------------------------------------------- PMINRES parity
def _indefinite():
    """An indefinite tridiagonal matrix (alternating +-4 diagonal), the
    JAX test's case for the absolute-value block-Jacobi."""
    n = 64
    a = np.diag(np.where(np.arange(n) % 2 == 0, 4.0, -4.0))
    for i in range(n - 1):
        a[i, i + 1] = a[i + 1, i] = 0.7
    return a


def _ani64():
    r, c, v, n = anisotropic_laplace2d(24, epsilon=EPS)
    a = np.zeros((n, n))
    a[r, c] = v
    return a


@pytest.mark.parametrize("problem,spec", [("anisotropic", "block_jacobi:24"),
                                          ("anisotropic", "block_jacobi:8"),
                                          ("indefinite",
                                           "block_jacobi_abs:2")])
def test_pminres_iterations_equal_the_reference(problem, spec):
    a = _ani64() if problem == "anisotropic" else _indefinite()
    n = a.shape[0]
    rhs = np.random.default_rng(13).standard_normal((n, 2))
    kw = dict(C=8, sigma=1, dtype=np.float64)
    with jax.enable_x64(True):
        Aj = jfrom_dense(a, **kw)
        Mj = jprecond.make_preconditioner(spec, matrix=Aj)
        jres = jmin.minres(jmake_operator(Aj, impl="ref"), Aj.permute(rhs),
                           tol=1e-9, maxiter=2000, M=Mj)
        j_iters, jx = int(jres.iters), np.asarray(Aj.unpermute(jres.x))
    A = from_dense(a, device="cpu", **kw)
    M = make_preconditioner(spec, matrix=A)
    res = minres(make_operator(A), A.permute(rhs), tol=1e-9, maxiter=2000,
                 M=M)
    assert bool(res.converged.all())
    assert res.iters == j_iters
    np.testing.assert_allclose(A.unpermute(res.x).numpy(), jx,
                               atol=1e-9 * np.abs(jx).max())
    x = A.unpermute(res.x).numpy()
    assert np.abs(a @ x - rhs).max() / np.abs(rhs).max() < 1e-7


@pytest.mark.parametrize("k", [1, 11])
def test_pminres_chunked_equals_monolithic(k):
    a = _ani64()
    A = from_dense(a, C=8, sigma=1, dtype=np.float32, device="cpu")
    op = make_operator(A)
    M = BlockJacobiPreconditioner(A, block_size=8)
    b = A.permute(np.random.default_rng(14).standard_normal(
        (a.shape[0], 2)).astype(np.float32))
    ref = minres(op, b, tol=1e-6, maxiter=400, M=M)
    st = minres_init(op, b, tol=1e-6, maxiter=400, M=M)
    assert isinstance(st, PrecondMinresState)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = minres_step(op, st, k, M=M)
    res = minres_finalize(st)
    assert res.iters == ref.iters and torch.equal(res.x, ref.x)


def test_pminres_state_from_jax_continues_identically():
    a = _indefinite()
    n = a.shape[0]
    rhs = np.random.default_rng(15).standard_normal((n, 2))
    kw = dict(C=8, sigma=1, dtype=np.float64)
    with jax.enable_x64(True):
        Aj = jfrom_dense(a, **kw)
        jop = jmake_operator(Aj, impl="ref")
        Mj = jprecond.make_preconditioner("block_jacobi_abs:2", matrix=Aj)
        jst = jmin.minres_step(jop, jmin.minres_init(
            jop, Aj.permute(rhs), tol=1e-9, maxiter=500, M=Mj), 6, M=Mj)
        arrays = {f: np.asarray(getattr(jst, f)) for f in jst._fields}
        jfinal = jmin.minres_finalize(jmin.minres_step(jop, jst, 500, M=Mj))
        j_iters, jx = int(jfinal.iters), np.asarray(jfinal.x)
    st = state_from_arrays(arrays, device="cpu")
    assert type(st) is PrecondMinresState and st.it == 6
    A = from_dense(a, device="cpu", **kw)
    M = make_preconditioner("block_jacobi_abs:2", matrix=A)
    res = minres_finalize(minres_step(make_operator(A), st, 500, M=M))
    assert res.iters == j_iters
    np.testing.assert_allclose(res.x.numpy(), jx,
                               atol=1e-9 * np.abs(jx).max())


def test_pminres_state_and_M_must_agree():
    A = from_dense(_indefinite(), C=8, sigma=1, device="cpu")
    op = make_operator(A)
    b = torch.ones(A.nrows_pad, 2, dtype=A.dtype)
    M = make_preconditioner("block_jacobi_abs:2", matrix=A)
    with pytest.raises(ValueError, match="with a preconditioner"):
        minres_step(op, minres_init(op, b, M=M), 3)
    with pytest.raises(ValueError, match="without a preconditioner"):
        minres_step(op, minres_init(op, b), 3, M=M)
    with pytest.raises(NotImplementedError, match="block=True"):
        minres(op, b, M=M, block=True)


# ------------------------------------------------------------- Chebyshev
def test_chebyshev_apply_matches_jax(bench):
    r2 = np.random.default_rng(16).standard_normal(
        (bench["A"].nrows_pad, 3)).astype(np.float32)
    Mj = jprecond.ChebyshevPreconditioner(bench["jop"], bench["spectrum"],
                                          degree=5)
    M = ChebyshevPreconditioner(bench["op"], bench["spectrum"], degree=5)
    assert (M.lo, M.hi) == (Mj.lo, Mj.hi)
    want = np.asarray(Mj.apply(jnp.asarray(r2)))
    assert _rel(M.apply(torch.from_numpy(r2)).numpy(), want) <= 1e-5
    assert M.apply(torch.from_numpy(r2[:, 0])).shape == (r2.shape[0],)


def test_chebyshev_clamps_and_refuses(bench):
    op = bench["op"]
    M = ChebyshevPreconditioner(op, (-5.0, 300.0), degree=2)
    assert M.lo == pytest.approx(10.0)
    with pytest.raises(ValueError, match="SPD"):
        ChebyshevPreconditioner(op, (-2.0, 0.0))
    with pytest.raises(ValueError, match="degree"):
        ChebyshevPreconditioner(op, (1.0, 2.0), degree=0)


def test_chebyshev_holds_its_operator_weakly(bench):
    op = make_operator(bench["A"])
    M = ChebyshevPreconditioner(op, bench["spectrum"])
    del op
    gc.collect()
    with pytest.raises(ReferenceError, match="garbage-collected"):
        M.apply(torch.zeros(bench["A"].nrows_pad))


# ------------------------------------------------------------ spec strings
@pytest.mark.parametrize("spec", ["block_jacobi", "block_jacobi:8",
                                  "block_jacobi_abs:4", "chebyshev:6",
                                  "chebyshev"])
def test_parse_precond_spec_matches_the_reference(spec):
    assert parse_precond_spec(spec) == jprecond.parse_precond_spec(spec)


@pytest.mark.parametrize("bad", ["", "ilu", "chebyshev:x",
                                 "block_jacobi:-2", "block_jacobi:0", None])
def test_parse_precond_spec_refuses_like_the_reference(bad):
    with pytest.raises(ValueError) as ours:
        parse_precond_spec(bad)
    with pytest.raises(ValueError) as theirs:
        jprecond.parse_precond_spec(bad)
    assert str(ours.value) == str(theirs.value)


def test_make_preconditioner_builds_and_refuses(bench):
    A, op = bench["A"], bench["op"]
    M = make_preconditioner("block_jacobi", matrix=A)
    assert M.block_size == A.C and not M.absolute
    assert make_preconditioner("block_jacobi_abs:8", matrix=A).absolute
    ch = make_preconditioner("chebyshev", op=op, spectrum=(1.0, 10.0))
    assert ch.degree == 4
    with pytest.raises(ValueError, match="needs op="):
        make_preconditioner("chebyshev")
    with pytest.raises(ValueError, match="needs op="):
        jprecond.make_preconditioner("chebyshev")
    with pytest.raises(TypeError, match="SELL-C-sigma"):
        make_preconditioner("block_jacobi")


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 4, 16])
@pytest.mark.parametrize("bs", [1, 4, 32, 48, MAX_BS])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32, torch.bfloat16,
                                torch.float16])
def test_block_diag_kernel_matches_plain_on_card(dt, bs, b):
    """The kernel against its plain version computed in float64 from the
    same inputs, within (bs + 2) units of the accumulation dtype times
    sum |B_ij| |x_jc|, plus half a unit of the output."""
    need_card()
    nb = 37
    g = torch.Generator(device="cuda").manual_seed(bs * 10 + b)
    blocks = torch.randn(nb, bs, bs, generator=g, dtype=torch.float64,
                         device="cuda").to(dt)
    x = torch.randn(nb * bs, b, generator=g, dtype=torch.float64,
                    device="cuda").to(dt)
    execution.reset_launch_counts()
    y = block_jacobi_apply(blocks, x)
    torch.cuda.synchronize()
    assert execution.launch_counts()["block_diag_matmul"] == 1
    assert y.dtype == dt
    want = block_diag_matmul_ref(blocks.double(), x.double())
    scale = block_diag_matmul_ref(blocks.double().abs(), x.double().abs())
    u = 2.0 ** -53 if dt == torch.float64 else 2.0 ** -24
    u_out = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}.get(dt, 0.0)
    fi = torch.finfo(dt)
    lim = ((bs + 2) * u * scale + (bs + 2) * 2.0 ** -53 * scale
           + u_out * want.abs() + fi.tiny * fi.eps)
    assert bool(((y.double() - want).abs() <= lim).all())


@pytest.mark.gpu
def test_block_diag_kernel_refuses_on_card():
    need_card()
    with pytest.raises(ValueError, match="outside"):
        block_jacobi_apply(torch.zeros(1, MAX_BS + 1, MAX_BS + 1,
                                       device="cuda"),
                           torch.zeros(MAX_BS + 1, 1, device="cuda"))
    with pytest.raises(NotImplementedError, match="complex"):
        block_jacobi_apply(torch.zeros(1, 2, 2, dtype=torch.complex64,
                                       device="cuda"),
                           torch.zeros(2, 1, dtype=torch.complex64,
                                       device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["block_jacobi:48", "chebyshev:4"])
def test_pcg_on_card_matches_the_cpu_count(spec):
    """table_precond.py's solve on the card takes the CPU's iteration
    count within one (float32 sums in another order) and launches B1
    and B4 as the recurrence says."""
    need_card()
    r, c, v, n = anisotropic_laplace2d(NX, epsilon=EPS)
    kw = dict(C=16, sigma=1, w_align=4, dtype=np.float32)
    b = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    A = from_coo(r, c, v, (n, n), device="cuda", **kw)
    op = make_operator(A)
    spectrum = (-215.77584185600335, 9916.002345228197)
    M = make_preconditioner(spec, matrix=A, op=op, spectrum=spectrum)
    execution.reset_launch_counts()
    res = cg(op, A.permute(torch.from_numpy(b)), tol=TOL, maxiter=MAXITER,
             M=M)
    torch.cuda.synchronize()
    counts = execution.launch_counts()
    assert bool(res.converged)
    assert abs(res.iters - RECORD[spec]) <= 1
    if spec.startswith("block_jacobi"):
        assert counts["sellcs_spmv"] == counts["block_diag_matmul"] \
            == res.iters + 1
    else:
        assert counts["sellcs_spmv"] == 4 * (res.iters + 1)
        assert counts.get("block_diag_matmul", 0) == 0
