"""KPM moments on a matrix whose row count is no multiple of C.

On a diagonal matrix Rademacher moments are exact whatever the probes:
mu_m = mean_i T_m(s_i) over the matrix's rows.  Padding rows are zero
rows, so probes that reach them add eigenvalue-0 terms.  The JAX package
draws its probes over all ``op.n`` padded rows (``nrows_pad`` for a
``GhostOperator``, ``nshards * m_pad`` for a ``DistOperator``), so its
moments carry that bias, and differently for the two operators.  The
port draws them on the real rows only (zero in the padding slots, scaled
by 1/sqrt(nrows)): its moments equal the exact ones within 2e-5 (32
Chebyshev steps in float32) on either operator, a deliberate difference
from the JAX package.  The JAX package's distributed operator runs in a
subprocess with two forced host devices, as ``tests/conftest.py``'s
``run_with_devices`` does.
"""
import numpy as np
import pytest

from conftest import run_with_devices
from repro_torch.core import from_coo
from repro_torch.runtime import DevicePool, HeterogeneousEngine
from repro_torch.solvers import kpm_dos_moments, make_operator

N, C, M, SPEC = 301, 8, 32, (-1.0, 2.0)     # 301 rows: padded to 304

REF_CODE = """
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import from_coo
from repro.runtime import DevicePool, HeterogeneousEngine
from repro.solvers import make_operator
from repro.solvers.kpm import kpm_dos_moments

d = np.random.default_rng(6).uniform(-0.9, 1.7, {n})
r = np.arange({n})
A = from_coo(r, r, d, ({n}, {n}), C={c}, sigma=1, dtype=np.float32)
ghost = kpm_dos_moments(make_operator(A, impl="ref"), {m}, n_probes=4,
                        spectrum={spec})
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
eng = HeterogeneousEngine(r, r, d, {n}, mesh=mesh,
                          pool=DevicePool.from_bandwidths([1.0, 1.0]),
                          C={c}, sigma=1, dtype=np.float32)
dist = kpm_dos_moments(make_operator(eng), {m}, n_probes=4, spectrum={spec})
np.savez({path!r}, ghost=np.asarray(ghost), dist=np.asarray(dist),
         n=make_operator(eng).n)
print("SUBPROCESS_OK")
"""


def _diagonal():
    d = np.random.default_rng(6).uniform(-0.9, 1.7, N)
    s = (d - 0.5) / 1.5
    exact = np.cos(np.arange(M)[:, None] * np.arccos(s)[None, :]).mean(1)
    return np.arange(N), d, exact


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    path = str(tmp_path_factory.mktemp("kpm_ref") / "ref.npz")
    code = REF_CODE.format(n=N, c=C, m=M, spec=SPEC, path=path)
    assert "SUBPROCESS_OK" in run_with_devices(code, 2)
    return dict(np.load(path))


def _ghost():
    r, d, _ = _diagonal()
    return make_operator(from_coo(r, r, d, (N, N), C=C, sigma=1,
                                  dtype=np.float32, device="cpu"))


def _dist():
    r, d, _ = _diagonal()
    eng = HeterogeneousEngine(r, r, d, N, devices=["cpu", "cpu"],
                              pool=DevicePool.from_bandwidths([1.0, 1.0]),
                              C=C, sigma=1, dtype=np.float32)
    return make_operator(eng)


def test_the_reference_counts_padded_rows(ref):
    """The fault, in the JAX package: on either operator its moments miss
    the exact ones by far more than float32 round-off, and by different
    amounts on the two operators (their padding differs)."""
    *_, exact = _diagonal()
    assert int(ref["n"]) > N
    for key in ("ghost", "dist"):
        assert np.abs(ref[key] - exact).max() > 1e-3, key
    assert np.abs(ref["ghost"] - ref["dist"]).max() > 1e-4


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("build", [_ghost, _dist], ids=["ghost", "dist"])
def test_port_moments_ignore_padding(ref, build, fused):
    """The repair: the port's moments equal the exact ones on the padded
    matrix, through either operator, so they differ from the JAX
    package's."""
    *_, exact = _diagonal()
    op = build()
    assert op.n > N
    got = kpm_dos_moments(op, M, n_probes=4, spectrum=SPEC, seed=0,
                          fused=fused).numpy()
    np.testing.assert_allclose(got, exact, atol=2e-5)
    assert got[0] == pytest.approx(1.0, abs=1e-6)
    assert np.abs(got - ref["ghost" if build is _ghost else "dist"]
                  ).max() > 1e-3
