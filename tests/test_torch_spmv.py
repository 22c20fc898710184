"""Parity of the port's fused SpMV with the JAX package's plain path
(``repro.core.spmv.spmv_ref``) for every fusion flag and store/compute
pair, and of the port's dispatch on the CPU.

Tolerances are normwise: ``|got - want| <= rtol * max|want|`` elementwise.
float64 runs the JAX side under ``jax.enable_x64`` with rtol 1e-12 (only
the summation order differs); float32 compute uses rtol 1e-5 for y and z
and for the dots, which the port accumulates in float64 and the JAX
package (x64 off) in Kahan-compensated float32.
"""
import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.core import sellcs as jsell
from repro.core import spmv as jspmv
from repro_torch.core import execution, ghost_spmv
from repro_torch.core import sellcs as tsell
from repro_torch.core import spmv as tspmv
from repro_torch.kernels import ops
from repro_torch.kernels.ref import sellcs_spmv_ref
from repro_torch.kernels.sellcs_spmv import sellcs_spmv_cuda
from repro_torch.solvers import GhostOperator, MatrixFreeOperator

PAIRS = [(np.float64, None), (np.float32, None), (np.float32, "bfloat16"),
         (np.float32, "float16"), (np.float64, "float32")]
FLAGS = {
    "plain": (dict(), False, False),
    "alpha_beta": (dict(alpha=0.7, beta=-1.3), True, False),
    "gamma_scalar": (dict(alpha=1.2, gamma=0.25), False, False),
    "gamma_column": (dict(gamma="column"), True, False),
    "chain": (dict(alpha=1.1, beta=0.5, delta=0.3, eta=-0.8), True, True),
    "dots": (dict(dot_yy=True, dot_xy=True, dot_xx=True), False, False),
    "everything": (dict(alpha=0.9, beta=0.4, gamma="column", delta=2.0,
                        eta=0.5, dot_yy=True, dot_xy=True, dot_xx=True),
                   True, True),
}


def _x64(on):
    return jax.enable_x64(True) if on else contextlib.nullcontext()


def close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _problem(seed=0, n=70):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < 0.12) * rng.standard_normal((n, n))
    d[::7] = 0.0
    rows, cols = np.nonzero(d)
    return rows, cols, d[rows, cols], (n, n)


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dtype,store", PAIRS,
                         ids=[f"{np.dtype(d).name}-{s}" for d, s in PAIRS])
def test_spmv_ref_matches_jax(dtype, store, b, flag):
    kw, with_y, with_z = FLAGS[flag]
    rows, cols, vals, shape = _problem()
    x64 = np.dtype(dtype) == np.float64
    rng = np.random.default_rng(1)
    build = dict(C=8, sigma=32, w_align=2, dtype=dtype, store_dtype=store)
    At = tsell.from_coo(rows, cols, vals, shape, device="cpu", **build)
    vshape = (At.nrows_pad,) if b == 1 else (At.nrows_pad, b)
    x, y, z = (rng.standard_normal(vshape).astype(dtype) for _ in range(3))
    kw = dict(kw)
    if kw.get("gamma") == "column":
        kw["gamma"] = rng.standard_normal(b).astype(dtype)
    with _x64(x64):
        Aj = jsell.from_coo(rows, cols, vals, shape, **build)
        jkw = dict(kw)
        if "gamma" in jkw:
            jkw["gamma"] = jnp.asarray(jkw["gamma"])
        yj, zj, dj = jspmv.spmv(Aj, jnp.asarray(x),
                                jnp.asarray(y) if with_y else None,
                                jnp.asarray(z) if with_z else None,
                                jspmv.SpmvOpts(**jkw), impl="ref")
        yj, zj, dj = (None if a is None else np.asarray(a)
                      for a in (yj, zj, dj))
    yt, zt, dt = tspmv.spmv(At, torch.from_numpy(x),
                            torch.from_numpy(y) if with_y else None,
                            torch.from_numpy(z) if with_z else None,
                            tspmv.SpmvOpts(**kw))
    rtol = 1e-12 if x64 else 1e-5
    assert str(yt.dtype) == f"torch.{np.dtype(dtype).name}"
    close(yt.numpy(), yj, rtol)
    assert (zt is None) == (zj is None)
    if zt is not None:
        close(zt.numpy(), zj, rtol)
    assert (dt is None) == (dj is None)
    if dt is not None:
        assert dt.dtype == torch.float64 and dt.shape == (3, b)
        close(dt.numpy(), dj, rtol)


def test_complex_spmv_ref_matches_jax():
    rows, cols, vals, shape = _problem(2)
    rng = np.random.default_rng(3)
    cvals = vals * (1 + 0.5j)
    x = rng.standard_normal((72, 2)) + 1j * rng.standard_normal((72, 2))
    opts = dict(alpha=0.5, gamma=0.1, dot_yy=True, dot_xy=True, dot_xx=True)
    At = tsell.from_coo(rows, cols, cvals, shape, C=8, sigma=16,
                        device="cpu")
    with _x64(True):
        Aj = jsell.from_coo(rows, cols, cvals, shape, C=8, sigma=16)
        yj, _, dj = jspmv.spmv_ref(Aj, jnp.asarray(x),
                                   opts=jspmv.SpmvOpts(**opts))
        yj, dj = np.asarray(yj), np.asarray(dj)
    yt, _, dt = ops.sellcs_spmv(At, torch.from_numpy(x),
                                opts=tspmv.SpmvOpts(**opts))
    assert dt.dtype == torch.complex128
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-12, atol=1e-10)


def test_rectangular_part_against_dense():
    """The port's plain SpMV takes a rectangular part (x with ncols rows),
    which the JAX package's ``spmv_ref`` rejects; held against numpy."""
    rng = np.random.default_rng(4)
    d = (rng.random((45, 30)) < 0.2) * rng.standard_normal((45, 30))
    rows, cols = np.nonzero(d)
    A = tsell.from_coo(rows, cols, d[rows, cols], d.shape, C=8, sigma=16,
                       device="cpu")
    x = rng.standard_normal((30, 2))
    y0 = rng.standard_normal((A.nrows_pad, 2))
    y, _, dots = tspmv.spmv(A, torch.from_numpy(x), torch.from_numpy(y0),
                            opts=tspmv.SpmvOpts(alpha=2.0, beta=0.5,
                                                dot_yy=True))
    want = 2.0 * np.vstack([d @ x, np.zeros((3, 2))])[A.perm.numpy()] + 0.5 * y0
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dots[0].numpy(), (want * want).sum(0),
                               rtol=1e-12)
    for bad in (tspmv.SpmvOpts(gamma=0.5), tspmv.SpmvOpts(dot_xy=True)):
        with pytest.raises(ValueError, match="square"):
            tspmv.spmv(A, torch.from_numpy(x), opts=bad)
    with pytest.raises(ValueError, match="rows"):
        tspmv.spmv(A, torch.zeros(A.nrows_pad, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="x must be permuted"):
        jspmv.spmv_ref(jsell.from_coo(rows, cols, d[rows, cols], d.shape,
                                      C=8, sigma=16), jnp.asarray(x))


def test_cpu_dispatch_runs_plain_version_without_launches():
    rows, cols, vals, shape = _problem(5)
    A = tsell.from_coo(rows, cols, vals, shape, C=8, sigma=16, device="cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((72, 2)))
    opts = tspmv.SpmvOpts(alpha=0.5, dot_xy=True)
    execution.reset_launch_counts()
    want = tspmv.spmv_ref(A, x, opts=opts)
    for got in (tspmv.spmv(A, x, opts=opts),
                tspmv.spmv(A, x, opts=opts, impl="cuda"),
                ghost_spmv(A, x, opts=opts),
                ops.sellcs_spmv(A, x, opts=opts),
                sellcs_spmv_ref(A, x, opts=opts)):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[2], want[2])
    assert execution.launch_counts().get("sellcs_spmv", 0) == 0
    with pytest.raises(ValueError, match="unknown impl"):
        tspmv.spmv(A, x, impl="pallas")


def test_cuda_wrapper_rejects_cpu_tensors():
    rows, cols, vals, shape = _problem(7)
    A = tsell.from_coo(rows, cols, vals, shape, C=8, sigma=16, device="cpu")
    x = torch.zeros(72, 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sellcs_spmv_cuda(A.vals, A.cols, A.chunk_off, A.chunk_len, x, C=8)


def test_helpers_match_jax():
    assert tspmv.storage_acc_dtype(torch.bfloat16) == torch.float32
    assert tspmv.storage_acc_dtype(torch.float16) == torch.float32
    assert tspmv.storage_acc_dtype(torch.float64) == torch.float64
    assert tspmv.dot_acc_dtype(torch.float32) == torch.float64
    assert tspmv.dot_acc_dtype(torch.complex64) == torch.complex128
    opts = dict(alpha=2.0, beta=-0.5, gamma=[0.25, 1.0, -1.0])
    with _x64(True):
        want = np.asarray(jspmv.pack_coefs(jspmv.SpmvOpts(**opts), 3,
                                           jnp.float64))
    got = tspmv.pack_coefs(tspmv.SpmvOpts(**opts), 3, torch.float64)
    np.testing.assert_array_equal(got.numpy(), want)
    v = torch.arange(4.0)
    v2, was1d = tspmv.as2d(v)
    assert was1d and v2.shape == (4, 1)
    assert tspmv.as2d(v2) == (v2, False)
    o = tspmv.SpmvOpts(delta=1.0)
    assert o.chain_axpby and not o.any_dot


@pytest.mark.parametrize("flag", list(FLAGS))
def test_matrix_free_operator_matches_ghost_operator(flag):
    kw, with_y, with_z = FLAGS[flag]
    rows, cols, vals, shape = _problem(8)
    A = tsell.from_coo(rows, cols, vals, shape, C=8, sigma=16,
                       device="cpu")
    rng = np.random.default_rng(9)
    x, y, z = (torch.from_numpy(rng.standard_normal((72, 2)))
               for _ in range(3))
    kw = dict(kw)
    if kw.get("gamma") == "column":
        kw["gamma"] = np.array([0.3, -0.7])
    opts = tspmv.SpmvOpts(**kw)
    g = GhostOperator(A)
    mf = MatrixFreeOperator(g.mv, g.n, g.dtype)
    got = mf.mv_fused(x, y if with_y else None, z if with_z else None, opts)
    want = g.mv_fused(x, y if with_y else None, z if with_z else None, opts)
    for a, b_ in zip(got, want):
        assert (a is None) == (b_ is None)
        if a is not None:
            close(a.numpy(), b_.numpy(), 1e-13)
