"""Parity of the port's SELL-C-sigma build with the JAX package's: the eight
arrays bit-identical (2-byte floats compared through an integer view) and
the static fields equal, over a grid of C, sigma, w_align and store dtype
that includes stored zeros, duplicates, empty rows and the empty matrix."""
import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX

from repro.core import sellcs as jsell
from repro_torch.core import sellcs as tsell
from repro_torch.interop import (SELLCS_ARRAYS, SELLCS_META,
                                 sellcs_from_arrays)


def _host(a) -> np.ndarray:
    """Array -> numpy, with 2-byte floats as their bit patterns."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float16):
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float16"):
        return a.view(np.uint16)
    return a


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", "")
    return np.asarray(a).dtype.name


def _x64(on: bool):
    return jax.enable_x64(True) if on else contextlib.nullcontext()


def assert_same_matrix(At, Aj):
    for f in SELLCS_ARRAYS:
        t, j = getattr(At, f), getattr(Aj, f)
        assert _dtype_name(t) == _dtype_name(j), f
        np.testing.assert_array_equal(_host(t), _host(j), err_msg=f)
    for f in SELLCS_META:
        assert getattr(At, f) == getattr(Aj, f), f


def build_both(rows, cols, vals, shape, *, dtype, **kw):
    with _x64(np.dtype(dtype) == np.float64):
        Aj = jsell.from_coo(rows, cols, vals, shape, dtype=dtype, **kw)
        jax.block_until_ready(Aj.vals)
    At = tsell.from_coo(rows, cols, vals, shape, dtype=dtype, device="cpu",
                        **kw)
    return At, Aj


def _random_problem(seed=0, n=57, ncols=None):
    """Square (or n x ncols) COO with stored zeros, duplicates and empty
    rows."""
    rng = np.random.default_rng(seed)
    ncols = n if ncols is None else ncols
    d = (rng.random((n, ncols)) < 0.15) * rng.standard_normal((n, ncols))
    d[::5] = 0.0                                  # empty rows
    rows, cols = np.nonzero(d)
    vals = d[rows, cols]
    zr = np.arange(1, min(n, ncols), 11)          # explicit stored zeros
    dup = rng.integers(0, rows.size, 6)           # duplicates (summed)
    rows = np.concatenate([rows, zr, rows[dup]])
    cols = np.concatenate([cols, zr, cols[dup]])
    vals = np.concatenate([vals, np.zeros(zr.size), rng.standard_normal(6)])
    return rows, cols, vals, (n, ncols)


PROBLEMS = {
    "square": _random_problem(0),
    "rectangular": _random_problem(1, n=40, ncols=23),
    "single_row_wide": (np.zeros(6, np.int64), np.array([0, 2, 4, 6, 8, 9]),
                        np.array([1.0, 2, 0, 4, 5, 6]), (1, 10)),
    "empty": (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0),
              (12, 12)),
}

DTYPE_PAIRS = [(np.float32, None), (np.float64, None),
               (np.float64, "float32"), (np.float32, "bfloat16"),
               (np.float32, "float16"), (np.float64, "bfloat16"),
               (np.float64, "float16")]


@pytest.mark.parametrize("dtype,store", DTYPE_PAIRS,
                         ids=[f"{np.dtype(d).name}-{s}" for d, s in DTYPE_PAIRS])
@pytest.mark.parametrize("w_align", [1, 4])
@pytest.mark.parametrize("C,sigma_mult", [(1, 1), (4, 0), (4, 1), (4, 4),
                                          (16, 0), (16, 2)])
def test_build_bit_identical(C, sigma_mult, w_align, dtype, store):
    sigma = max(1, C * sigma_mult)
    for name, (rows, cols, vals, shape) in PROBLEMS.items():
        if name == "empty" and np.dtype(dtype) == np.float64:
            continue          # the JAX package drops dtype= here, see below
        At, Aj = build_both(rows, cols, vals, shape, dtype=dtype, C=C,
                            sigma=sigma, w_align=w_align, store_dtype=store)
        assert_same_matrix(At, Aj)
        assert At.cap == Aj.cap and At.nchunks == Aj.nchunks
        assert At.beta == Aj.beta
        assert str(At.dtype).replace("torch.", "") == str(Aj.dtype)
        assert _dtype_name(At.vals) == str(Aj.store_dtype)


def test_empty_matrix_keeps_requested_dtype():
    """A documented difference: the JAX package builds an empty matrix in
    float32 whatever ``dtype=`` asks; the port keeps float64."""
    rows, cols, vals, shape = PROBLEMS["empty"]
    At, Aj = build_both(rows, cols, vals, shape, dtype=np.float64, C=4,
                        sigma=8)
    assert At.vals.dtype == torch.float64
    assert _dtype_name(Aj.vals) == "float32"
    for f in SELLCS_ARRAYS[1:]:
        np.testing.assert_array_equal(_host(getattr(At, f)),
                                      _host(getattr(Aj, f)))


def test_external_row_perm_and_column_override():
    rows, cols, vals, shape = PROBLEMS["square"]
    perm = np.random.default_rng(3).permutation(64)
    At, Aj = build_both(rows, cols, vals, shape, dtype=np.float32, C=8,
                        row_perm=perm)
    assert_same_matrix(At, Aj)
    assert not At.permuted_cols
    At, Aj = build_both(rows, cols, vals, shape, dtype=np.float32, C=8,
                        sigma=16, permute_columns=False)
    assert_same_matrix(At, Aj)


@pytest.mark.parametrize("store", [None, "bfloat16", "float16"])
def test_interop_matches_port_build(store):
    rows, cols, vals, shape = PROBLEMS["square"]
    At, Aj = build_both(rows, cols, vals, shape, dtype=np.float32, C=8,
                        sigma=32, w_align=2, store_dtype=store)
    arrays = {f: np.asarray(getattr(Aj, f)) for f in SELLCS_ARRAYS}
    meta = {f: getattr(Aj, f) for f in SELLCS_META}
    Ai = sellcs_from_arrays(arrays, meta, device="cpu")
    assert_same_matrix(Ai, Aj)
    for f in SELLCS_ARRAYS:
        assert torch.equal(getattr(Ai, f), getattr(At, f)), f


def test_interop_rejects_missing_fields():
    with pytest.raises(ValueError, match="missing"):
        sellcs_from_arrays({}, {}, device="cpu")


BAD_BUILDS = [
    ("sigma", dict(C=4, sigma=6), "multiple of C"),
    ("row", dict(rows=[0, 9]), "row index out of range"),
    ("col", dict(cols=[0, 9]), "col index out of range"),
    ("row_perm", dict(row_perm=np.arange(3)), "row_perm must have shape"),
    ("store_int", dict(store_dtype="int32"), "real floating dtype"),
    ("store_wider", dict(dtype=np.float32, store_dtype="float64"),
     "wider than the compute dtype"),
    ("store_complex_compute", dict(vals=[1 + 1j, 2], store_dtype="float32"),
     "not supported for complex"),
    ("store_int_compute", dict(vals=[1, 2], store_dtype="float32"),
     "requires a floating compute dtype"),
]


@pytest.mark.parametrize("what,kw,msg", BAD_BUILDS,
                         ids=[b[0] for b in BAD_BUILDS])
def test_validation_raises_match(what, kw, msg):
    kw = dict(kw)
    rows = kw.pop("rows", [0, 1])
    cols = kw.pop("cols", [1, 0])
    vals = kw.pop("vals", [1.0, 2.0])
    with pytest.raises(ValueError, match=msg):
        jsell.from_coo(rows, cols, vals, (4, 4), **kw)
    with pytest.raises(ValueError, match=msg):
        tsell.from_coo(rows, cols, vals, (4, 4), device="cpu", **kw)


def test_builders_and_accessors_agree():
    rows, cols, vals, shape = PROBLEMS["square"]
    kw = dict(C=8, sigma=16, w_align=2, dtype=np.float32)
    At, Aj = build_both(rows, cols, vals, shape, **kw)
    np.testing.assert_array_equal(tsell.to_dense(At), jsell.to_dense(Aj))
    np.testing.assert_array_equal(At.nnz_per_row(), Aj.nnz_per_row())
    np.testing.assert_array_equal(At.valid_slots(), Aj.valid_slots())
    assert At.shape == Aj.shape and At.nrows_pad == Aj.nrows_pad

    dense = jsell.to_dense(Aj)
    np.testing.assert_array_equal(
        tsell.to_dense(tsell.from_dense(dense, device="cpu", **kw)), dense)
    sp_rows, sp_cols = np.nonzero(dense)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(sp_rows,
                                                        minlength=57))])
    Ac = tsell.from_csr(indptr, sp_cols, dense[sp_rows, sp_cols], shape,
                        device="cpu", **kw)
    assert_same_matrix(Ac, jsell.from_csr(indptr, sp_cols,
                                          dense[sp_rows, sp_cols], shape, **kw))

    def rowfunc(i):
        nz = np.nonzero(dense[i])[0]
        return nz, dense[i, nz]
    Ab = tsell.from_callback(rowfunc, 57, device="cpu", **kw)
    assert_same_matrix(Ab, jsell.from_callback(rowfunc, 57, **kw))
    with pytest.raises(ValueError, match="maxnz_per_row"):
        tsell.from_callback(rowfunc, 57, maxnz_per_row=1, device="cpu", **kw)

    v = np.random.default_rng(2).standard_normal((57, 3)).astype(np.float32)
    vp = At.permute(torch.from_numpy(v))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(Aj.permute(v)))
    np.testing.assert_array_equal(At.unpermute(vp).numpy(), v)
