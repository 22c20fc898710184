"""Parity of the port's block vectors (``repro_torch.core.blockvec``) and
tall-skinny GEMM wrappers (``repro_torch.kernels.ops.tsmttsm``/``tsmm``,
plain on the CPU) with the JAX package.

Inputs are made from a numpy seed and handed to both packages; float64
runs the JAX side under ``jax.enable_x64``.  The ops are also held to the
Pallas kernels ``tsmttsm_pallas`` / ``tsmm_pallas`` in interpret mode.

Tolerances: float64 agrees to 1e-12 relative (the two sum in other
orders).  A float32 product of length n is held to the standard
dot-product bound ``n * eps * (|V|^T |W|)`` (computed in float64), which
covers any summation order; element-wise BLAS-1 results agree exactly.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.core import blockvec as jbv  # noqa: E402
from repro.kernels.tsmm import tsmm_pallas  # noqa: E402
from repro.kernels.tsmttsm import tsmttsm_pallas  # noqa: E402
from repro_torch.core import blockvec as bv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import tsmm_ref, tsmttsm_ref  # noqa: E402

N = 1500                      # not a multiple of the 512-row tile
DIMS = [(1, 1), (3, 8), (8, 3), (16, 16)]
DTYPES = [np.float32, np.float64]


def _x64(dtype):
    return jax.enable_x64(dtype == np.float64)


def _data(dtype, m, k, n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, m)).astype(dtype),
            rng.standard_normal((n, k)).astype(dtype),
            rng.standard_normal((m, k)).astype(dtype))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_product(got, want, V, W, dtype, scale=1.0):
    """``got`` against ``want`` within the dot-product error bound of a
    length-n product of V and W (float32), or 1e-12 relative (float64)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(want).max(), 1))
        return
    bound = (V.shape[0] * np.finfo(np.float32).eps * scale
             * (np.abs(V.astype(np.float64)).T @ np.abs(W.astype(np.float64))))
    assert np.all(np.abs(got - want) <= bound + 1e-6), \
        np.abs(got - want).max()


def _close_dot(got, want, x, y, dtype, scale=1.0):
    """Column dots: the diagonal of :func:`_close_product`'s bound."""
    _close_product(np.diag(np.asarray(got)), np.diag(np.asarray(want)),
                   x, y, dtype, scale)


# ------------------------------------------------------------- blockvec
@pytest.mark.parametrize("with_x", [False, True])
@pytest.mark.parametrize("m,k", DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tsmttsm_matches_jax(dtype, m, k, with_x):
    V, W, X = _data(dtype, m, k)
    kw = dict(alpha=0.5, beta=-2.0) if with_x else dict(alpha=1.5)
    with _x64(dtype):
        want = np.asarray(jbv.tsmttsm(jnp.asarray(V), jnp.asarray(W),
                                      jnp.asarray(X) if with_x else None,
                                      **kw))
    got = bv.tsmttsm(_t(V), _t(W), _t(X) if with_x else None, **kw)
    assert got.dtype == _t(want).dtype
    _close_product(got.numpy(), want, V, W, dtype, scale=2.0)


@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("m,k", DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tsmm_matches_jax(dtype, m, k, with_w):
    V, W, _ = _data(dtype, m, k)
    X = np.random.default_rng(1).standard_normal((m, k)).astype(dtype)
    kw = dict(alpha=0.5, beta=-2.0) if with_w else dict(alpha=1.5)
    with _x64(dtype):
        want = np.asarray(jbv.tsmm(jnp.asarray(V), jnp.asarray(X),
                                   jnp.asarray(W) if with_w else None, **kw))
    got = bv.tsmm(_t(V), _t(X), _t(W) if with_w else None, **kw)
    assert got.dtype == _t(want).dtype
    # a length-m product per entry
    tol = (1e-12 if dtype == np.float64 else 1e-5) * max(np.abs(want).max(), 1)
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    Xsq = np.random.default_rng(2).standard_normal((m, m)).astype(dtype)
    with _x64(dtype):
        want_in = np.asarray(jbv.tsmm_inplace(jnp.asarray(V), jnp.asarray(Xsq),
                                              2.0, 1.0))
    inplace = bv.tsmm_inplace(_t(V), _t(Xsq), 2.0, 1.0)
    np.testing.assert_allclose(inplace.numpy(), want_in,
                               atol=10 * tol * max(np.abs(want_in).max(), 1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_kahan_matches_jax(dtype):
    V, W, _ = _data(dtype, 3, 8, n=2000)
    with _x64(dtype):
        want = np.asarray(jbv.tsmttsm_kahan(jnp.asarray(V), jnp.asarray(W)))
        want_dot = np.asarray(jbv.dot_kahan(jnp.asarray(V[:, :3]),
                                            jnp.asarray(W[:, :3])))
    got = bv.tsmttsm_kahan(_t(V), _t(W))
    # the per-256-row partials may sum in another order; the Kahan pass
    # over the partials is the same in both
    _close_product(got.numpy(), want, V, W, dtype, scale=256 / 2000)
    got_dot = bv.dot_kahan(_t(V[:, :3]), _t(W[:, :3]))
    _close_dot(got_dot.numpy(), want_dot, V[:, :3], W[:, :3], dtype,
               scale=256 / 2000)


def test_kahan_reduce_compensates():
    """Sixteen thousand float32 terms of 0.1 after a 1e4 start: the
    compensated sum is within one ulp of the float64 sum, the plain
    float32 sum far from it."""
    terms = np.full((16001, 1), 0.1, np.float32)
    terms[0] = 1e4
    exact = terms.astype(np.float64).sum()
    got = float(bv._kahan_reduce(_t(terms))[0])
    jgot = float(jbv._kahan_reduce(jnp.asarray(terms))[0])
    assert abs(got - exact) <= np.spacing(np.float32(exact))
    assert got == jgot
    assert abs(float(np.cumsum(terms[:, 0], dtype=np.float32)[-1]) - exact) > 1


BLAS1 = {
    "axpy": lambda m, y, x, a, b: m.axpy(y, x, 0.75),
    "axpby": lambda m, y, x, a, b: m.axpby(y, x, 0.75, -1.25),
    "scal": lambda m, y, x, a, b: m.scal(x, 0.75),
    "dot": lambda m, y, x, a, b: m.dot(x, y),
    "vaxpy": lambda m, y, x, a, b: m.vaxpy(y, x, a),
    "vaxpby": lambda m, y, x, a, b: m.vaxpby(y, x, a, b),
    "vscal": lambda m, y, x, a, b: m.vscal(x, a),
}


@pytest.mark.parametrize("name", list(BLAS1))
@pytest.mark.parametrize("dtype", DTYPES)
def test_blas1_matches_jax(dtype, name):
    rng = np.random.default_rng(3)
    y, x = (rng.standard_normal((N, 4)).astype(dtype) for _ in range(2))
    a, b = (rng.standard_normal(4).astype(dtype) for _ in range(2))
    with _x64(dtype):
        want = np.asarray(BLAS1[name](jbv, jnp.asarray(y), jnp.asarray(x),
                                      jnp.asarray(a), jnp.asarray(b)))
    got = BLAS1[name](bv, _t(y), _t(x), a, b).numpy()
    assert got.dtype == want.dtype
    if name == "dot":          # a length-n sum, in other orders
        _close_dot(got, want, x, y, dtype)
    else:                      # element-wise: the same roundings
        np.testing.assert_array_equal(got, want)


def test_views_match_jax():
    V = np.random.default_rng(4).standard_normal((10, 6))
    with _x64(np.float64):
        jv = jbv.view_cols(jnp.asarray(V), [4, 1, 3])
        want = np.asarray(jbv.compact_clone(jv))
        want_cm = np.asarray(jbv.to_col_major(jnp.asarray(V)))
    got = bv.compact_clone(bv.view_cols(_t(V), [4, 1, 3]))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    cm = bv.to_col_major(_t(V))
    np.testing.assert_array_equal(cm.numpy(), want_cm)
    np.testing.assert_array_equal(bv.to_row_major(cm).numpy(), V)


@pytest.mark.parametrize("beta", [1.0, 0.5, "tensor"])
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_check_beta_needs_out_raises(pkg, beta):
    V, W, X = _data(np.float32, 3, 3, n=20)
    if pkg == "jax":
        b = jnp.asarray(2.0) if beta == "tensor" else beta
        mod, arrs = jbv, (jnp.asarray(V), jnp.asarray(W), jnp.asarray(X))
        with pytest.raises(ValueError, match="beta"):
            jbv.check_beta_needs_out(b, None, "f")
    else:
        b = torch.tensor(2.0) if beta == "tensor" else beta
        mod, arrs = bv, (_t(V), _t(W), _t(X))
        with pytest.raises(ValueError, match="beta"):
            bv.check_beta_needs_out(b, None, "f")
        for fn in (ops.tsmttsm, ops.tsmm):
            with pytest.raises(ValueError, match="beta"):
                fn(arrs[0], arrs[1] if fn is ops.tsmttsm else arrs[2],
                   None, 1.0, b)
    with pytest.raises(ValueError, match="beta"):
        mod.tsmttsm(arrs[0], arrs[1], None, 1.0, b)
    with pytest.raises(ValueError, match="beta"):
        mod.tsmm(arrs[0], arrs[2], None, 1.0, b)
    mod.check_beta_needs_out(0.0, None, "f")       # beta = 0 is fine
    mod.check_beta_needs_out(b, arrs[2], "f")      # so is an output


# ------------------------------------------- ops against the Pallas kernels
def _pad(a, rows):
    return np.concatenate([a, np.zeros((rows - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


@pytest.mark.parametrize("with_x", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
@pytest.mark.parametrize("m,k", DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ops_tsmttsm_matches_pallas(dtype, m, k, kahan, with_x):
    V, W, X = _data(dtype, m, k, seed=5)
    kw = dict(alpha=0.5, beta=-2.0) if with_x else dict(alpha=1.5)
    rows = -(-N // 512) * 512
    with _x64(dtype):
        want = np.asarray(tsmttsm_pallas(
            jnp.asarray(_pad(V, rows)), jnp.asarray(_pad(W, rows)),
            jnp.asarray(X) if with_x else None, row_tile=512, kahan=kahan,
            interpret=True, **kw))
    got = ops.tsmttsm(_t(V), _t(W), _t(X) if with_x else None, kahan=kahan,
                      **kw)
    assert got.dtype == _t(want).dtype
    _close_product(got.numpy(), want, V, W, dtype, scale=2.0)
    ref = tsmttsm_ref(_t(V), _t(W), _t(X) if with_x else None, kahan=kahan,
                      **kw)
    assert torch.equal(got, ref)            # the CPU path is the plain one


@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("m,k", DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ops_tsmm_matches_pallas(dtype, m, k, with_w):
    V, W, _ = _data(dtype, m, k, seed=6)
    X = np.random.default_rng(7).standard_normal((m, k)).astype(dtype)
    kw = dict(alpha=0.5, beta=-2.0) if with_w else dict(alpha=1.5)
    rows = -(-N // 512) * 512
    with _x64(dtype):
        want = np.asarray(tsmm_pallas(
            jnp.asarray(_pad(V, rows)), jnp.asarray(X),
            jnp.asarray(_pad(W, rows)) if with_w else None, row_tile=512,
            interpret=True, **kw))[:N]
    got = ops.tsmm(_t(V), _t(X), _t(W) if with_w else None, **kw)
    assert got.dtype == _t(want).dtype
    tol = (1e-12 if dtype == np.float64 else 1e-5) * max(np.abs(want).max(), 1)
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    assert torch.equal(got, tsmm_ref(_t(V), _t(X), _t(W) if with_w else None,
                                     **kw))
    Xsq = _t(np.random.default_rng(8).standard_normal((m, m)).astype(dtype))
    both = ops.tsmm_inplace(_t(V), Xsq, 0.5, 2.0)
    assert torch.equal(both, tsmm_ref(_t(V), Xsq, _t(V), 0.5, 2.0))


def test_ops_result_dtype_follows_the_pallas_kernel():
    """For bfloat16 operands the result is bfloat16, as the Pallas kernel
    returns it (the JAX package's ``blockvec.tsmttsm`` returns float32),
    and the sums run in float32."""
    V, W, _ = _data(np.float32, 4, 4, n=64)
    Vb, Wb = _t(V).bfloat16(), _t(W).bfloat16()
    got = ops.tsmttsm(Vb, Wb)
    assert got.dtype == torch.bfloat16
    assert bv.tsmttsm(Vb, Wb).dtype == torch.float32
    want = (Vb.float().T @ Wb.float()).bfloat16()
    assert torch.equal(got, want)
    assert ops.tsmm(Vb, Wb[:4]).dtype == torch.bfloat16


def test_ops_n_zero():
    V = torch.zeros((0, 3), dtype=torch.float64)
    W = torch.zeros((0, 5), dtype=torch.float64)
    X = torch.ones((3, 5), dtype=torch.float64)
    assert torch.equal(ops.tsmttsm(V, W, X, 2.0, 0.5), 0.5 * X)
    assert torch.equal(ops.tsmttsm(V, W, kahan=True), torch.zeros(3, 5,
                                                                  dtype=X.dtype))
    assert ops.tsmm(V, X).shape == (0, 5)
