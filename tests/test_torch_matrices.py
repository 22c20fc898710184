"""Parity of the port's matrix generators and Matrix Market IO with the
JAX package's: identical COO triplets, and files that read back the same
in both packages."""
import numpy as np
import pytest
import torch  # noqa: F401

jax = pytest.importorskip("jax")   # the reference package needs JAX

from repro.matrices import generators as jgen
from repro.matrices import mmio as jmmio
from repro_torch.matrices import generators as tgen
from repro_torch.matrices import mmio as tmmio

GENERATOR_CASES = [
    ("matpde", (12,), {}),
    ("matpde", (9, 7), {"beta_c": 0.0}),
    ("matpde", (8,), {"beta_c": 5.0, "gamma_c": 3.0}),
    ("laplace2d", (10,), {}),
    ("laplace2d", (6, 11), {}),
    ("laplace3d", (7,), {}),
    ("anisotropic_laplace2d", (9,), {}),
    ("anisotropic_laplace2d", (5, 8), {"epsilon": 0.3}),
    ("anderson3d", (5,), {}),
    ("anderson3d", (4,), {"disorder": 3.0, "seed": 7}),
    ("graphene", (4, 5), {}),
    ("graphene", (3, 3), {"t": -1.0, "onsite_disorder": 0.5, "seed": 2}),
    ("spin_chain_xx", (6,), {}),
    ("spin_chain_xx", (5,), {"jz": 0.3}),
    ("banded_random", (60,), {}),
    ("banded_random", (50,), {"bw": 4, "density": 0.9, "seed": 3,
                              "sym": True}),
]


@pytest.mark.parametrize("name,args,kw", GENERATOR_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(GENERATOR_CASES)])
def test_generator_triplets_identical(name, args, kw):
    want = getattr(jgen, name)(*args, **kw)
    got = getattr(tgen, name)(*args, **kw)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_generator_exports_match():
    assert sorted(tgen.__all__) == sorted(jgen.__all__)


def test_anisotropic_rejects_nonpositive_epsilon():
    for mod in (jgen, tgen):
        with pytest.raises(ValueError, match="epsilon"):
            mod.anisotropic_laplace2d(4, epsilon=0.0)


def _triplets(field, rng, n=9, nnz=20):
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    if field == "complex":
        vals = rng.standard_normal(nnz) + 1j * rng.standard_normal(nnz)
    elif field == "integer":
        vals = rng.integers(-2 ** 40, 2 ** 40, nnz)
    else:
        vals = rng.standard_normal(nnz)
    return rows, cols, vals


@pytest.mark.parametrize("field", ["real", "integer", "complex", "pattern"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_matrix_market_round_trip(tmp_path, field, writer):
    rng = np.random.default_rng(5)
    rows, cols, vals = _triplets(field, rng)
    path = tmp_path / "m.mtx"
    write = tmmio.write_matrix_market if writer == "port" else \
        jmmio.write_matrix_market
    write(path, rows, cols, vals, (9, 9),
          field="pattern" if field == "pattern" else None)
    got = tmmio.read_matrix_market(path)
    want = jmmio.read_matrix_market(path)
    assert got[3] == want[3] == (9, 9)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], rows)
    np.testing.assert_array_equal(got[1], cols)
    if field != "pattern":
        np.testing.assert_array_equal(got[2], vals)


@pytest.mark.parametrize("symmetry",
                         ["symmetric", "skew-symmetric", "hermitian"])
def test_matrix_market_symmetry_expansion(tmp_path, symmetry):
    rows = np.array([0, 1, 2, 2])
    cols = np.array([0, 0, 1, 2])
    vals = np.array([1.0 + 0.5j, 2.0 - 1j, -3.0 + 2j, 4.0])
    field = "complex" if symmetry == "hermitian" else None
    if field is None:
        vals = vals.real.copy()
    path = tmp_path / "s.mtx.gz"
    tmmio.write_matrix_market(path, rows, cols, vals, (3, 3), field=field,
                              symmetry=symmetry)
    got = tmmio.read_matrix_market(path)
    want = jmmio.read_matrix_market(path)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[0].size == 6                       # 4 stored + 2 mirrored


def test_matrix_market_rejects_bad_headers(tmp_path):
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    for mod in (tmmio, jmmio):
        with pytest.raises(ValueError, match="coordinate"):
            mod.read_matrix_market(bad)
    with pytest.raises(ValueError, match="symmetry"):
        tmmio.write_matrix_market(tmp_path / "x.mtx", [0], [0], [1.0], (1, 1),
                                  symmetry="upper")
