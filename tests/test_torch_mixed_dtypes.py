"""Mixed operand dtypes of kernels B1–B4, on the CPU: the port's
``kernels/ops.py`` against the JAX package's ops, pair by pair, and the
two solves that need the pairs (a complex right-hand side on a real
matrix), and B2's column-block split.

Each Pallas kernel returns the ``result_type`` of its operands, so the
JAX package's ops take operands of different dtypes; the port returns
the same dtype, on the CPU through its plain versions (checked here) and
on the card through a kernel instance or an exact conversion (the
``gpu``-marked tests of ``tests/test_torch_wide_card.py`` and
``tests/test_torch_precond.py``, and ``chip_smoke.py``'s mixed-dtype
phase).  The same numpy inputs, made from a seed, go to both packages:
B1's JAX side through ``repro.core.spmv.spmv_ref`` (its Pallas kernel
fails on jax 0.9.0), B2–B4 through the JAX ops with their Pallas kernels
in interpret mode, as the JAX package's own tests run them (complex
operands take the ops' plain path there).  Tolerances: max |port - JAX|
at most 1e-12 of max |JAX| for 64-bit results (float64, complex128) and
1e-5 for 32-bit ones (the two sum in other orders); result dtypes equal;
iteration counts equal.
"""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core.spmv import SpmvOpts as JSpmvOpts  # noqa: E402
from repro.core.spmv import spmv_ref as jspmv_ref  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.solvers import make_operator as jmake_operator  # noqa: E402
from repro.solvers import precond as jprecond  # noqa: E402
from repro_torch.core import SpmvOpts, execution, from_coo  # noqa: E402
from repro_torch.interop import tensor_from_array  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tsmttsm as b2  # noqa: E402
from repro_torch.kernels.ref import tsmttsm_ref  # noqa: E402
from repro_torch.matrices import anisotropic_laplace2d, laplace3d  # noqa: E402
from repro_torch.solvers import cg, make_operator, make_preconditioner  # noqa: E402

jcg = importlib.import_module("repro.solvers.cg")
ml_dtypes = pytest.importorskip("ml_dtypes")

NP = {"float64": np.float64, "float32": np.float32,
      "bfloat16": ml_dtypes.bfloat16, "float16": np.float16,
      "complex128": np.complex128, "complex64": np.complex64}
#: pairs of operand dtypes whose result differs from one of them: real
#: widths, real with complex, complex of two precisions
PAIRS = [("float64", "float32"), ("float32", "float64"),
         ("float32", "bfloat16"), ("bfloat16", "float16"),
         ("float16", "float64"), ("complex128", "float64"),
         ("float64", "complex128"), ("complex64", "float32"),
         ("float32", "complex64"), ("complex64", "complex128"),
         ("complex128", "complex64"), ("complex64", "float64"),
         ("float64", "complex64"), ("bfloat16", "complex64")]
#: B1: (the matrix' compute dtype, its stored dtype, x's dtype)
B1_PAIRS = [("float64", "float64", "float32"),
            ("float32", "float32", "float64"),
            ("float32", "float32", "bfloat16"),
            ("complex128", "complex128", "float64"),
            ("float64", "float64", "complex128"),
            ("complex64", "complex64", "float32"),
            ("float32", "float32", "complex64"),
            ("complex64", "complex64", "complex128"),
            ("complex128", "complex128", "complex64"),
            ("complex64", "complex64", "float64"),
            ("float64", "float64", "complex64"),
            ("float32", "float32", "complex128"),
            ("float32", "bfloat16", "complex64"),
            ("float32", "bfloat16", "float64")]


def _arr(rng, shape, name):
    a = rng.standard_normal(shape)
    if name.startswith("complex"):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(NP[name])


def _tol(dtype_name: str) -> float:
    return 1e-12 if dtype_name in ("float64", "complex128") else 1e-5


def _check(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    assert str(got.dtype)[6:] == want.dtype.name, what
    w = want.astype(np.complex128)
    g = got.to(torch.complex128).numpy()
    assert g.shape == w.shape, what
    scale = np.abs(w).max()
    assert np.abs(g - w).max() <= _tol(want.dtype.name) * scale, what


def _t(a):
    return tensor_from_array(a, "cpu")


@pytest.mark.parametrize("vd,wd", PAIRS, ids=lambda p: p)
def test_tsmttsm_pairs_match_jax(vd, wd):
    rng = np.random.default_rng(20)
    V, W = _arr(rng, (96, 6), vd), _arr(rng, (96, 5), wd)
    cx = vd.startswith("complex") or wd.startswith("complex")
    alpha, beta = (0.5 - 0.5j, 2.0j) if cx else (0.5, -2.0)
    # X in the result dtype, as a caller of the mixed op holds it
    with jax.enable_x64(True):
        rt = jnp.result_type(jnp.asarray(V).dtype, jnp.asarray(W).dtype)
    X = _arr(rng, (6, 5), rt.name)
    for kahan in (False, True):
        with jax.enable_x64(True):
            want = np.asarray(jops.tsmttsm(
                jnp.asarray(V), jnp.asarray(W), jnp.asarray(X), alpha, beta,
                kahan=kahan, interpret=True))
        got = ops.tsmttsm(_t(V), _t(W), _t(X), alpha, beta, kahan=kahan)
        _check(got, want, f"tsmttsm {vd} x {wd} kahan={kahan}")


@pytest.mark.parametrize("vd,xd", PAIRS, ids=lambda p: p)
def test_tsmm_pairs_match_jax(vd, xd):
    rng = np.random.default_rng(21)
    V, X = _arr(rng, (96, 6), vd), _arr(rng, (6, 5), xd)
    cx = vd.startswith("complex") or xd.startswith("complex")
    alpha, beta = (1.5j, 0.5) if cx else (1.5, 0.5)
    # W in the result dtype, as a caller of the mixed op holds it
    with jax.enable_x64(True):
        rt = jnp.result_type(jnp.asarray(V).dtype, jnp.asarray(X).dtype)
        W = _arr(rng, (96, 5), rt.name)
        for with_w in (False, True):
            want = np.asarray(jops.tsmm(
                jnp.asarray(V), jnp.asarray(X),
                jnp.asarray(W) if with_w else None, alpha,
                beta if with_w else 0.0, interpret=True))
            got = ops.tsmm(_t(V), _t(X), _t(W) if with_w else None, alpha,
                           beta if with_w else 0.0)
            _check(got, want, f"tsmm {vd} x {xd} with_w={with_w}")


@pytest.mark.parametrize("bd,xd", PAIRS, ids=lambda p: p)
def test_block_jacobi_apply_pairs_match_jax(bd, xd):
    rng = np.random.default_rng(22)
    blocks, x = _arr(rng, (6, 8, 8), bd), _arr(rng, (48, 3), xd)
    with jax.enable_x64(True):
        want = np.asarray(jops.block_jacobi_apply(
            jnp.asarray(blocks), jnp.asarray(x), interpret=True))
    _check(ops.block_jacobi_apply(_t(blocks), _t(x)), want,
           f"block_jacobi_apply {bd} x {xd}")


@pytest.mark.parametrize("ct,st,xd", B1_PAIRS, ids=lambda p: p)
def test_sellcs_spmv_pairs_match_jax(ct, st, xd):
    """Every fusion flag: (A - gamma I) x scaled and shifted, y and z in
    x's dtype, the chained axpby and the three dots."""
    r, c, v, n = laplace3d(5)
    rng = np.random.default_rng(23)
    vals = np.asarray(v, np.float64)
    if ct.startswith("complex"):
        vals = vals * np.exp(1j * rng.uniform(0, 2 * np.pi, vals.size))
    kw = dict(C=8, sigma=16, dtype=NP[ct],
              store_dtype=None if st == ct else NP[st])
    x, y, z = (_arr(rng, (n, 3), xd) for _ in range(3))
    cx = ct.startswith("complex") or xd.startswith("complex")
    coefs = dict(alpha=0.5 - 0.25j, beta=-1.0 + 0.5j, gamma=0.25j,
                 delta=2.0, eta=0.5 + 1j) if cx else dict(
        alpha=0.5, beta=-1.0, gamma=0.25, delta=2.0, eta=0.5)
    flags = dict(dot_yy=True, dot_xy=True, dot_xx=True)
    with jax.enable_x64(True):
        Aj = jfrom_coo(r, c, vals, (n, n), **kw)
        jy, jz, jd = (np.asarray(a) for a in jspmv_ref(
            Aj, *(Aj.permute(jnp.asarray(a)) for a in (x, y, z)),
            JSpmvOpts(**coefs, **flags)))
    A = from_coo(r, c, vals, (n, n), device="cpu", **kw)
    gy, gz, gd = ops.sellcs_spmv(A, *(A.permute(_t(a)) for a in (x, y, z)),
                                 SpmvOpts(**coefs, **flags))
    for got, want, what in ((gy, jy, "y"), (gz, jz, "z"), (gd, jd, "dots")):
        _check(got, want, f"sellcs_spmv {st}/{ct} x {xd}: {what}")


# --------------------------------------------------- B2's column blocks
@pytest.mark.parametrize("dt", ["float32", "complex64"])
def test_column_blocks_past_the_limit(dt, monkeypatch):
    """Where three stages of one row of V and W exceed STAGE_LIMIT (here
    lowered, with the stage size, so that a small call is past it), the
    call runs as column blocks: their widths fit the limit, and the blocks
    assembled equal the JAX op on the whole call."""
    td = getattr(torch, dt)
    m, k = 300, 200
    assert b2.column_blocks(m, k, td.itemsize, td) == (m, k)
    monkeypatch.setattr(b2, "STAGE_BYTES", 1024)
    limit = b2.stage_smem(m, k, td.itemsize, td) // 2
    monkeypatch.setattr(b2, "STAGE_LIMIT", limit)
    mb, kb = b2.column_blocks(m, k, td.itemsize, td)
    assert mb < m and kb < k
    assert b2.stage_smem(mb, kb, td.itemsize, td) <= limit
    rng = np.random.default_rng(24)
    V, W, X = _arr(rng, (64, m), dt), _arr(rng, (64, k), dt), \
        _arr(rng, (m, k), dt)
    alpha, beta = (0.5 - 0.5j, 2.0j) if td.is_complex else (0.5, -2.0)
    for kahan in (False, True):
        with jax.enable_x64(True):
            want = np.asarray(jops.tsmttsm(
                jnp.asarray(V), jnp.asarray(W), jnp.asarray(X), alpha, beta,
                kahan=kahan, interpret=True))
        got = b2.by_column_blocks(
            lambda Vi, Wj, Xij, a, b: tsmttsm_ref(Vi, Wj, Xij, a, b,
                                                  kahan=kahan),
            _t(V), _t(W), _t(X), alpha, beta, mb, kb)
        _check(got, want, f"column blocks {dt} kahan={kahan}")


# ---------------------------------------------------------------- solves
def test_column_cg_complex_rhs_on_real_matrix():
    """Column CG with a complex128 right-hand side on a real float64
    laplace3d(12): the JAX package's iteration count (49), in complex128,
    with no kernel launched on the CPU."""
    r, c, v, n = laplace3d(12)
    rng = np.random.default_rng(3)
    b = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
    kw = dict(C=32, sigma=1, dtype=np.float64)
    with jax.enable_x64(True):
        Aj = jfrom_coo(r, c, v, (n, n), **kw)
        jres = jcg.cg(jmake_operator(Aj, impl="ref"),
                      Aj.permute(jnp.asarray(b)), tol=1e-8, maxiter=2000)
        jits = int(jres.iters)
    A = from_coo(r, c, v, (n, n), device="cpu", **kw)
    execution.reset_launch_counts()
    res = cg(make_operator(A), A.permute(torch.from_numpy(b)), tol=1e-8,
             maxiter=2000)
    assert bool(res.converged.all()) and bool(np.all(jres.converged))
    assert res.iters == jits == 49
    assert res.x.dtype == torch.complex128
    assert not any(execution.launch_counts().values())


def test_block_jacobi_pcg_complex_rhs_real_blocks():
    """Block-Jacobi PCG with real blocks on a complex right-hand side
    (anisotropic_laplace2d(32), blocks of 16): the JAX package's count."""
    r, c, v, n = anisotropic_laplace2d(32, epsilon=1e-2)
    rng = np.random.default_rng(4)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    kw = dict(C=16, sigma=1, dtype=np.float64)
    with jax.enable_x64(True):
        Aj = jfrom_coo(r, c, v, (n, n), **kw)
        Mj = jprecond.make_preconditioner("block_jacobi:16", matrix=Aj)
        jres = jcg.cg(jmake_operator(Aj, impl="ref"),
                      Aj.permute(jnp.asarray(b)), tol=1e-8, maxiter=4000,
                      M=Mj)
        jits = int(jres.iters)
    A = from_coo(r, c, v, (n, n), device="cpu", **kw)
    M = make_preconditioner("block_jacobi:16", matrix=A)
    res = cg(make_operator(A), A.permute(torch.from_numpy(b)), tol=1e-8,
             maxiter=4000, M=M)
    assert bool(res.converged) and bool(jres.converged)
    assert res.iters == jits
    assert res.x.dtype == torch.complex128
