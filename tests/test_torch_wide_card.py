"""The kernels past the widths of their narrow designs, on the card: B2
and B3 past m, k = 64, the eigensolver past m = 64, B1 past C = 256
(ELLPACK included), B4 past bs = 64 and B6 past N = 64 and B = 65535,
each held against its plain version computed in float64 (complex128) from
the same inputs, and block CG at width 72.

Every test here is ``gpu``-marked and skips without a card (run with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_wide_card.py``);
the file imports no JAX, so it runs on a machine without it.  The CPU
parity of the same sizes against the JAX package is
``tests/test_torch_wide.py``.  Tolerances:

* B2 and B3: ``|kernel - plain| <= TOL * (|V|^T |W|)`` (``|V| |X|``)
  entry by entry, TOL = (depth + 2) units of the accumulation dtype, with
  depth the longest chain of additions (B2: ``summation_depth``; B3: m,
  twice that for complex values, whose products round up to sqrt(5)
  units, and half a unit of a bfloat16 result);
* B1: max |kernel - plain| / max |plain| at most 1e-12 (float64,
  complex128) and 1e-5 (float32), dots 1e-12 / 1e-6 (the sums run in
  another order);
* B4: ``(bs + 2)`` units of the accumulation dtype times ``|B| |x|``;
* B6: ``mamba_scan.error_bound`` (the kernel's exponential charged);
* the eigensolver: as ``tests/test_torch_herm_eig.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SpmvOpts, execution, from_coo
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels.ops import (block_jacobi_apply, herm_eig,
                                     mamba_scan, sellcs_spmv, tsmm,
                                     tsmm_inplace, tsmttsm)
from repro_torch.kernels.ref import (block_diag_matmul_ref, mamba_scan_ref,
                                     sellcs_spmv_ref, tsmm_ref, tsmttsm_ref)
from repro_torch.kernels.tsmttsm import summation_depth
from repro_torch.matrices import laplace3d
from repro_torch.solvers import cg, make_operator

pytestmark = pytest.mark.gpu

UNIT = {torch.float64: 2.0 ** -53, torch.float32: 2.0 ** -24,
        torch.complex128: 2.0 ** -53, torch.complex64: 2.0 ** -24}
WIDE = {torch.float64: torch.float64, torch.float32: torch.float64,
        torch.complex128: torch.complex128, torch.complex64: torch.complex128}
DTYPES = [torch.float64, torch.float32, torch.complex128]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _randn(shape, dtype, g):
    return torch.randn(*shape, generator=g, device="cuda",
                       dtype=WIDE[dtype]).to(dtype)


def _within(got, want, scale, depth, dtype):
    lim = (depth + 2) * UNIT[dtype] * scale + 1e-300
    err = (got.to(want.dtype) - want).abs()
    assert bool((err <= lim).all()), float((err / lim).max())


@pytest.mark.parametrize("kahan", [False, True])
@pytest.mark.parametrize("n,m,k", [(4109, 65, 65), (4109, 96, 96),
                                   (4109, 128, 128), (4109, 100, 72),
                                   (37, 128, 1), (70001, 80, 130)])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_wide_tsmttsm_matches_plain(dtype, n, m, k, kahan):
    need_card()
    g = torch.Generator(device="cuda").manual_seed(n + m + 3 * k)
    V, W, X = (_randn(s, dtype, g) for s in ((n, m), (n, k), (m, k)))
    alpha, beta = (0.5 - 0.5j, -2.0 + 1.0j) if dtype.is_complex else (0.5,
                                                                       -2.0)
    execution.reset_launch_counts()
    got = tsmttsm(V, W, X, alpha, beta, kahan=kahan)
    assert execution.launch_counts()["tsmttsm"] == 1
    assert got.dtype == dtype and got.shape == (m, k)
    w = WIDE[dtype]
    want = tsmttsm_ref(V.to(w), W.to(w), X.to(w), alpha, beta)
    scale = (abs(alpha) * (V.to(w).abs().T @ W.to(w).abs())
             + abs(beta) * X.to(w).abs())
    _within(got, want, scale.real, summation_depth(n, m, k, dtype), dtype)
    # the row partition alone fixes the order: a second call, and the same
    # values on views one element off their allocation, to the bit
    assert torch.equal(tsmttsm(V, W, X, alpha, beta, kahan=kahan), got)
    Vv = torch.empty(n * m + 1, dtype=dtype, device="cuda")[1:].view(n, m)
    Vv.copy_(V)
    assert torch.equal(tsmttsm(Vv, W, X, alpha, beta, kahan=kahan), got)


@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("n,m,k", [(4109, 65, 65), (4109, 96, 130),
                                   (4109, 128, 128), (4109, 100, 72),
                                   (5, 200, 3), (70001, 1, 65)])
@pytest.mark.parametrize("dtype", DTYPES + [torch.bfloat16],
                         ids=lambda d: str(d)[6:])
def test_wide_tsmm_matches_plain(dtype, n, m, k, with_w):
    need_card()
    g = torch.Generator(device="cuda").manual_seed(n + 2 * m + k)
    wide = torch.complex128 if dtype.is_complex else torch.float64
    V, X, W = (torch.randn(*s, generator=g, device="cuda",
                           dtype=wide).to(dtype)
               for s in ((n, m), (m, k), (n, k)))
    alpha, beta = (1.5j, 0.5) if dtype.is_complex else (1.5, 0.5)
    execution.reset_launch_counts()
    got = tsmm(V, X, W if with_w else None, alpha, beta if with_w else 0.0)
    assert execution.launch_counts()["tsmm"] == 1
    assert got.dtype == dtype and got.shape == (n, k)
    Vd, Xd, Wd = (t.to(wide) for t in (V, X, W))
    want = tsmm_ref(Vd, Xd, Wd if with_w else None, alpha,
                    beta if with_w else 0.0)
    scale = abs(alpha) * (Vd.abs() @ Xd.abs())
    if with_w:
        scale = scale + abs(beta) * Wd.abs()
    unit = UNIT.get(dtype, 2.0 ** -24)
    out_unit = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    # a complex product or scaling rounds up to sqrt(5) units, not one
    depth = 2 * (m + 2) if dtype.is_complex else m + 2
    lim = depth * unit * scale.real + out_unit * want.abs() + 1e-300
    assert bool(((got.to(wide) - want).abs() <= lim).all())


def test_wide_tsmm_inplace_aliases_v():
    """W_out is a new buffer, so W_in may be V itself."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(96)
    V = torch.randn(4109, 96, generator=g, dtype=torch.float64, device="cuda")
    X = torch.randn(96, 96, generator=g, dtype=torch.float64, device="cuda")
    want = tsmm_ref(V, X, V.clone(), 0.5, -1.0)
    got = tsmm_inplace(V, X, alpha=0.5, beta=-1.0)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_wide_herm_eig_at_200():
    """The wide instance with A in device memory (float64 at m = 200 does
    not fit beside the rotations in shared memory)."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(200)
    X = torch.randn(200, 200, generator=g, dtype=torch.float64, device="cuda")
    A = X @ X.T
    w, U, conv = herm_eig(A)
    assert bool(conv)
    eps, norm = 2.0 ** -52, float(torch.linalg.norm(A))
    assert bool(torch.all(w[1:] >= w[:-1]))
    want = torch.linalg.eigvalsh(A)
    assert float((w - want).abs().max()) <= 4 * 200 * eps * norm
    assert float(torch.linalg.norm(A @ U - U * w)) <= 16 * 200 * eps * norm
    assert float(torch.linalg.norm(U.T @ U - torch.eye(200, device="cuda",
                                                       dtype=A.dtype))) \
        <= 16 * 200 * eps


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128],
                         ids=lambda d: str(d)[6:])
def test_wide_herm_eig_batch_equals_one_at_a_time(dtype):
    """A batch of wide matrices, a block and a workspace slice each,
    equals the matrices one at a time to the bit."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(96)
    X = _randn((3, 96, 96), dtype, g)
    A = X @ X.mH
    w, U, conv = herm_eig(A)
    assert bool(conv.all()) and w.shape == (3, 96)
    for i in range(3):
        wi, Ui, _ = herm_eig(A[i])
        assert torch.equal(wi, w[i]) and torch.equal(Ui, U[i])


@pytest.mark.parametrize("m", [40, 54, 72])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128, torch.complex64],
                         ids=lambda d: str(d)[6:])
def test_herm_eig_where_shared_memory_needs_the_opt_in(dtype, m):
    """Widths where the static and dynamic shared memory together pass the
    48 KB that a launch gets without the opt-in (float64 at m = 54 in the
    narrow design, m = 72 in the wide one)."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(m)
    X = _randn((m, m), dtype, g)
    A = X @ X.mH
    w, U, conv = herm_eig(A)
    assert bool(conv)
    w_want = torch.linalg.eigvalsh(A.to(WIDE[dtype]))
    eps = torch.finfo(w.dtype).eps
    norm = float(torch.linalg.norm(A.to(WIDE[dtype])))
    assert float((w.double() - w_want).abs().max()) <= 4 * m * eps * norm


def _tall_matrix(C, np_dt, n=9000, seed=0):
    rng = np.random.default_rng(seed)
    rowlen = rng.integers(0, 12, n)
    rows = np.repeat(np.arange(n), rowlen)
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size)
    if np.dtype(np_dt).kind == "c":
        vals = vals * np.exp(1j * rng.uniform(0, 2 * np.pi, rows.size))
    C = n if C is None else C
    return from_coo(rows, cols, vals, (n, n), C=C, sigma=1, dtype=np_dt,
                    device="cuda")


@pytest.mark.parametrize("dots", [False, True])
@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("C", [512, 4096, None], ids=["512", "4096", "ell"])
@pytest.mark.parametrize("dt,np_dt", [(torch.float64, np.float64),
                                      (torch.float32, np.float32),
                                      (torch.complex128, np.complex128)],
                         ids=["float64", "float32", "complex128"])
def test_tall_chunks_match_plain(dt, np_dt, C, b, dots):
    """Chunks past 256 rows (C = nrows: ELLPACK, one chunk) spread over
    several blocks; the dots' partials are summed in a fixed order, so a
    second call gives the same bits."""
    need_card()
    A = _tall_matrix(C, np_dt)
    assert A.C > 256
    g = torch.Generator(device="cuda").manual_seed(b)
    x = _randn((A.nrows_pad, b), dt, g)
    y0 = _randn((A.nrows_pad, b), dt, g)
    opts = (SpmvOpts(alpha=0.5, beta=-1.0, dot_yy=True, dot_xy=True,
                     dot_xx=True) if dots else SpmvOpts(alpha=0.5, beta=-1.0))
    execution.reset_launch_counts()
    got = sellcs_spmv(A, x, y0, opts=opts)
    assert execution.launch_counts()["sellcs_spmv"] == 1
    want = sellcs_spmv_ref(A, x, y0, opts=opts)
    tol = 1e-5 if dt == torch.float32 else 1e-12
    scale = float(want[0].abs().max())
    assert float((got[0] - want[0]).abs().max()) <= tol * scale
    if dots:
        dtol = 1e-6 if dt == torch.float32 else 1e-12
        assert float((got[2] - want[2]).abs().max()) <= dtol * float(
            want[2].abs().max())
        again = sellcs_spmv(A, x, y0, opts=opts)
        assert torch.equal(again[2], got[2])


@pytest.mark.parametrize("b", [1, 4, 17])
@pytest.mark.parametrize("bs", [65, 128, 256])
@pytest.mark.parametrize("tb,tx", [(torch.float64, torch.float64),
                                   (torch.float32, torch.float32),
                                   (torch.complex128, torch.complex128),
                                   (torch.complex128, torch.float64),
                                   (torch.float64, torch.float32)],
                         ids=["f64", "f32", "c128", "c128-f64", "f64-f32"])
def test_wide_block_diag_matches_plain(tb, tx, bs, b):
    need_card()
    g = torch.Generator(device="cuda").manual_seed(bs + b)
    nb = 5
    blocks = _randn((nb, bs, bs), tb, g)
    x = _randn((nb * bs, b), tx, g)
    execution.reset_launch_counts()
    y = block_jacobi_apply(blocks, x)
    assert execution.launch_counts()["block_diag_matmul"] == 1
    out = torch.promote_types(tb, tx)
    assert y.dtype == out and y.shape == (nb * bs, b)
    w = WIDE[out]
    want = block_diag_matmul_ref(blocks.to(w), x.to(w))
    scale = block_diag_matmul_ref(blocks.to(w).abs(), x.to(w).abs())
    _within(y, want, scale.real, bs, out)


@pytest.mark.parametrize("B,S,di,N", [(1, 40, 24, 65), (2, 33, 40, 128),
                                      (1, 20, 16, 256), (1, 17, 8, 520),
                                      (65536, 3, 4, 16), (65537, 2, 3, 65)])
def test_wide_scan_within_its_bound(B, S, di, N):
    need_card()
    args = ms_inputs(B, S, di, N, seed=B + S + di + N)
    execution.reset_launch_counts()
    got = mamba_scan(*args)
    assert execution.launch_counts()["mamba_scan"] == 1
    want = mamba_scan_ref(*(a.double() for a in args))
    assert bool(((got - want).abs() <= ms.error_bound(*args)).all())


def ms_inputs(B, S, di, N, seed):
    """The scan's operands as a Mamba layer gives them: dt > 0 (softplus),
    A < 0, on the card in float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    dt = torch.nn.functional.softplus(r(B, S, di) - 2.0)
    A = -torch.exp(r(di, N) * 0.5)
    return dt, r(B, S, di), r(B, S, N), r(B, S, N), A


def test_block_cg_at_width_72():
    """cg(block=True) past the old width of 64: every kernel of the path
    (B1 at b = 72, B2 and B3 at 72 x 72, the eigensolver at m = 72)
    launches, and every column converges to its true residual."""
    need_card()
    r, c, v, n = laplace3d(12)
    A = from_coo(r, c, v, (n, n), C=32, sigma=64, dtype=np.float64,
                 device="cuda")
    g = torch.Generator(device="cuda").manual_seed(72)
    b = A.permute(torch.randn(n, 72, generator=g, dtype=torch.float64,
                              device="cuda"))
    execution.reset_launch_counts()
    res = cg(make_operator(A), b, tol=1e-8, maxiter=500, block=True)
    counts = execution.launch_counts()
    assert bool(res.converged.all())
    for name in ("sellcs_spmv", "tsmttsm", "tsmm", "herm_eig"):
        assert counts.get(name, 0) > 0, name
    Ax, _, _ = sellcs_spmv_ref(A, res.x)
    relres = (b - Ax).norm(dim=0) / b.norm(dim=0)
    assert float(relres.max()) <= 1e-7
