"""The kernels past the widths of their narrow designs, on the card: B2
and B3 past m, k = 64, the eigensolver past m = 64, B1 past C = 256
(ELLPACK included), B4 past bs = 64 and B6 past N = 64 and B = 65535,
each held against its plain version computed in float64 (complex128) from
the same inputs, and block CG at width 72; and the redesigned wide
instances (B2 in float64 on the FP64 tensor cores, the eigensolver as
block Jacobi) at the shapes the block-Krylov path gives them.

Every test here is ``gpu``-marked and skips without a card (run with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_wide_card.py``);
the file imports no JAX, so it runs on a machine without it.  The CPU
parity of the same sizes against the JAX package is
``tests/test_torch_wide.py``.  Tolerances:

* B2 and B3: ``|kernel - plain| <= TOL * (|V|^T |W|)`` (``|V| |X|``)
  entry by entry, TOL = (depth + 2) units of the accumulation dtype, with
  depth the longest chain of additions (B2: ``summation_depth``, Kahan
  to the compensated depth 8 + 3 (2 + 2 d^2 u) of ``chip_smoke.py``'s
  ``kahan_depth``, plus the float64 plain version's n; B3: m,
  twice that for complex values, whose products round up to sqrt(5)
  units, and half a unit of a bfloat16 result);
* B2's float64 Kahan sums at 2^18 rows also against exact sums of
  sampled entries (``tsmttsm_exact_entries``): within (kahan depth + 3)
  units of sum |terms| with no term for a reference's rounding, and a
  root-mean-square error at most KAHAN_GAIN of the plain sum's, each
  entry's error in units of its exact sum's ulp plus 2^-53 sqrt(sum
  terms^2) (``chip_smoke.py:_require_exact_kahan``);
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
                                     sellcs_spmv_ref, tsmm_ref, tsmttsm_ref,
                                     tsmttsm_exact_entries)
from repro_torch.kernels.tsmttsm import summation_depth, uses_dmma
from repro_torch.matrices import laplace3d
from repro_torch.solvers import cg, cg_finalize, cg_init, cg_step, make_operator

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


# ------------------------------------ B2's float64 instance on DMMA (PR 30)
DMMA_DIMS = [(65, 65), (72, 100), (128, 128), (200, 136)]
DMMA_NS = [0, 1, 37, 4109, 1 << 18]


def _dmma_bound(V, W, X, alpha, beta, kahan):
    """|kernel - plain| allowed entry by entry in float64: the kernel's
    depth (compensated with Kahan) and the plain version's n additions,
    each in units of 2^-53 of sum |terms|."""
    n, m = V.shape
    k = W.shape[1]
    d = summation_depth(n, m, k, torch.float64)
    depth = 8 + 3 * (2 + 2 * d * d * 2.0 ** -53) if kahan else d
    scale = abs(float(alpha)) * (V.abs().T @ W.abs())
    if X is not None:
        scale = scale + abs(float(beta)) * X.abs()
    return ((depth + 3) + (n + 3)) * 2.0 ** -53 * scale + 1e-300


@pytest.mark.parametrize("kahan", [False, True], ids=["plain", "kahan"])
@pytest.mark.parametrize("n", DMMA_NS)
@pytest.mark.parametrize("m,k", DMMA_DIMS)
def test_dmma_tsmttsm_matches_plain(m, k, n, kahan):
    """The FP64 tensor-core instance against the float64 plain version,
    with X, alpha and beta, and a second call to the same bits."""
    need_card()
    assert uses_dmma(m, k, torch.float64)
    g = torch.Generator(device="cuda").manual_seed(30 + n + m + k)
    V, W, X = (torch.randn(*s, generator=g, dtype=torch.float64,
                           device="cuda") for s in ((n, m), (n, k), (m, k)))
    execution.reset_launch_counts()
    got = tsmttsm(V, W, X, 0.5, -2.0, kahan=kahan)
    assert execution.launch_counts()["tsmttsm"] == 1
    want = tsmttsm_ref(V, W, X, 0.5, -2.0)
    assert bool(((got - want).abs()
                 <= _dmma_bound(V, W, X, 0.5, -2.0, kahan)).all())
    assert torch.equal(tsmttsm(V, W, X, 0.5, -2.0, kahan=kahan), got)


@pytest.mark.parametrize("kahan", [False, True], ids=["plain", "kahan"])
@pytest.mark.parametrize("m,k", DMMA_DIMS)
def test_dmma_tsmttsm_coefficients_on_the_card(m, k, kahan):
    """alpha and beta as 0-d tensors on the card give the bits that the
    same numbers give."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(m * k)
    V, W, X = (torch.randn(*s, generator=g, dtype=torch.float64,
                           device="cuda") for s in ((4109, m), (4109, k),
                                                    (m, k)))
    a = torch.tensor(-0.75, dtype=torch.float64, device="cuda")
    b = torch.tensor(1.5, dtype=torch.float64, device="cuda")
    got = tsmttsm(V, W, X, a, b, kahan=kahan)
    assert torch.equal(got, tsmttsm(V, W, X, -0.75, 1.5, kahan=kahan))
    want = tsmttsm_ref(V, W, X, -0.75, 1.5)
    assert bool(((got - want).abs()
                 <= _dmma_bound(V, W, X, -0.75, 1.5, kahan)).all())


@pytest.mark.parametrize("kahan", [False, True], ids=["plain", "kahan"])
@pytest.mark.parametrize("shift", [(1, 0), (0, 1), (1, 1)],
                         ids=["V", "W", "both"])
@pytest.mark.parametrize("m,k", DMMA_DIMS)
def test_dmma_tsmttsm_views_off_16_bytes(m, k, shift, kahan):
    """Operands one value past a 16-byte boundary fill the stages value by
    value; the sums, and so the bits, are those of aligned copies."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(m + 7 * k)
    n = 4109
    V, W = (torch.randn(n, d, generator=g, dtype=torch.float64,
                        device="cuda") for d in (m, k))

    def shifted(T, off):
        buf = torch.empty(T.numel() + off, dtype=T.dtype, device="cuda")
        view = buf[off:].view(T.shape)
        view.copy_(T)
        return view

    Vs, Ws = shifted(V, shift[0]), shifted(W, shift[1])
    assert (Vs.data_ptr() % 16 != 0) == bool(shift[0])
    assert torch.equal(tsmttsm(Vs, Ws, kahan=kahan),
                       tsmttsm(V, W, kahan=kahan))


@pytest.mark.parametrize("kahan", [False, True], ids=["plain", "kahan"])
@pytest.mark.parametrize("m", [65, 128, 200])
def test_dmma_tsmttsm_self_gram(m, kahan):
    """V the same tensor as W (block CG's SVQB Gram: the entries on and
    above the diagonal, mirrored) and V a copy of W (every entry) are both
    within the bound of the plain version; the self-Gram is symmetric to
    the bit, with X and beta too."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(m)
    W = torch.randn(1 << 18, m, generator=g, dtype=torch.float64,
                    device="cuda")
    want = tsmttsm_ref(W, W)
    bound = _dmma_bound(W, W, None, 1.0, 0.0, kahan)
    same = tsmttsm(W, W, kahan=kahan)
    copy = tsmttsm(W.clone(), W, kahan=kahan)
    for got in (same, copy):
        assert bool(((got - want).abs() <= bound).all())
    assert torch.equal(same, same.T)
    X = torch.randn(m, m, generator=g, dtype=torch.float64, device="cuda")
    X = X + X.T
    got = tsmttsm(W, W, X, 0.5, -2.0, kahan=kahan)
    assert torch.equal(got, got.T)
    assert bool(((got - tsmttsm_ref(W, W, X, 0.5, -2.0)).abs()
                 <= _dmma_bound(W, W, X, 0.5, -2.0, kahan)).all())


def test_block_cg_at_width_128_chunked_equals_monolithic():
    """Block CG at width 128 (B2 on DMMA, the block-Jacobi eigensolver on
    its path) in cg_step chunks is the monolithic solve, bit for bit:
    every sum on the path has a fixed order."""
    need_card()
    r, c, v, n = laplace3d(10)
    A = from_coo(r, c, v, (n, n), C=32, sigma=64, dtype=np.float64,
                 device="cuda")
    op = make_operator(A)
    g = torch.Generator(device="cuda").manual_seed(128)
    b = A.permute(torch.randn(n, 128, generator=g, dtype=torch.float64,
                              device="cuda"))
    res = cg(op, b, tol=1e-8, maxiter=300, block=True)
    st = cg_init(op, b, tol=1e-8, maxiter=300, block=True)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = cg_step(op, st, 7)
    ch = cg_finalize(st)
    assert bool(res.converged.all()) and ch.iters == res.iters
    assert torch.equal(ch.x, res.x)


#: the Kahan sum's root-mean-square error against exact sums at most this
#: share of the plain sum's (chip_smoke.py's KAHAN_GAIN; an emulation of
#: the DMMA order gives 0.17 off the diagonal and 0.30 on it at 2^18 rows,
#: a kernel that does not compensate 1)
KAHAN_GAIN = 0.5


@pytest.mark.parametrize("self_gram", [False, True],
                         ids=["VtW", "self-Gram"])
@pytest.mark.parametrize("m,k", DMMA_DIMS)
def test_dmma_kahan_against_exact_sums(m, k, self_gram):
    """The Kahan sum against exact sums of its diagonal and 64 random
    entries: within its compensated bound and well below the plain sum's
    error, which the float64 plain version's own rounding would hide (a
    self-Gram's diagonal is a sum of n positive terms)."""
    need_card()
    n = 1 << 18
    g = torch.Generator(device="cuda").manual_seed(m + k + self_gram)
    W = torch.randn(n, k, generator=g, dtype=torch.float64, device="cuda")
    V = W if self_gram else torch.randn(n, m, generator=g,
                                        dtype=torch.float64, device="cuda")
    m = V.shape[1]
    diag = torch.arange(min(m, k), device="cuda")
    rows = torch.cat([diag, torch.randint(m, (64,), generator=g,
                                          device="cuda")])
    cols = torch.cat([diag, torch.randint(k, (64,), generator=g,
                                          device="cuda")])
    hi, lo = tsmttsm_exact_entries(V, W, rows, cols)
    err = {kahan: ((tsmttsm(V, W, kahan=kahan)[rows, cols] - hi) - lo).abs()
           for kahan in (False, True)}
    d = summation_depth(n, m, k, torch.float64)
    depth = 8 + 3 * (2 + 2 * d * d * 2.0 ** -53)
    scale = (V[:, rows].abs() * W[:, cols].abs()).sum(0)
    assert bool((err[True] <= (depth + 3) * 2.0 ** -53 * scale).all())
    unit = (torch.ldexp(torch.ones_like(hi), torch.frexp(hi)[1] - 53)
            + 2.0 ** -53 * (V[:, rows] * W[:, cols]).square().sum(0).sqrt())
    rms = {kahan: float((e / unit).square().mean().sqrt())
           for kahan, e in err.items()}
    assert rms[True] <= KAHAN_GAIN * rms[False]


# ------------------------------- the redesigned wide B3 (tsmm_dmma) and B4
WIDE_MK = [65, 96, 128, 130, 200]


def _shifted(T):
    """``T``'s values in a view one value past a 16-byte boundary."""
    buf = torch.empty(T.numel() + 1, dtype=T.dtype, device=T.device)
    view = buf[1:].view(T.shape)
    view.copy_(T)
    return view


@pytest.mark.parametrize("with_w", [False, True], ids=["noW", "W"])
@pytest.mark.parametrize("k", WIDE_MK)
@pytest.mark.parametrize("m", WIDE_MK)
def test_dmma_tsmm_matches_plain(m, k, with_w):
    """The persistent FP64 tensor-core instance at an odd row count against
    the float64 plain version; a second call, alpha and beta as 0-d tensors
    on the card, and V (and W) one value off 16 bytes (filled value by
    value) all give the same bits."""
    _check_dmma_tsmm(m, k, with_w)


@pytest.mark.parametrize("with_w", [False, True], ids=["noW", "W"])
@pytest.mark.parametrize("m,k", [(128, 16), (200, 40), (96, 1), (130, 64),
                                 (65, 33)])
def test_dmma_tsmm_with_k_at_most_64(m, k, with_w):
    """m past 64 with k at most 64 also takes the 128-column instance, the
    columns past k masked: the same checks as at wide k."""
    _check_dmma_tsmm(m, k, with_w)


def _check_dmma_tsmm(m, k, with_w):
    need_card()
    n = 4099
    g = torch.Generator(device="cuda").manual_seed(m * k + with_w)
    V, X, W = (torch.randn(*s, generator=g, dtype=torch.float64,
                           device="cuda") for s in ((n, m), (m, k), (n, k)))
    Win, beta = (W, -0.5) if with_w else (None, 0.0)
    execution.reset_launch_counts()
    got = tsmm(V, X, Win, 1.5, beta)
    assert execution.launch_counts()["tsmm"] == 1
    want = tsmm_ref(V, X, Win, 1.5, beta)
    scale = 1.5 * (V.abs() @ X.abs()) + (0.5 * W.abs() if with_w else 0.0)
    _within(got, want, scale, m + 2, torch.float64)
    assert torch.equal(tsmm(V, X, Win, 1.5, beta), got)
    a, b = (torch.tensor(v, dtype=torch.float64, device="cuda")
            for v in (1.5, beta))
    assert torch.equal(tsmm(V, X, Win, a, b), got)
    Vs = _shifted(V)
    assert Vs.data_ptr() % 16 != 0
    assert torch.equal(tsmm(Vs, X, None if Win is None else _shifted(W),
                            1.5, beta), got)


@pytest.mark.parametrize("m", [65, 128, 200])
def test_dmma_tsmm_inplace(m):
    """W_in the same tensor as V (tsmm_inplace) past width 64."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(m)
    V = torch.randn(4099, m, generator=g, dtype=torch.float64, device="cuda")
    X = torch.randn(m, m, generator=g, dtype=torch.float64, device="cuda")
    got = tsmm_inplace(V, X, alpha=0.5, beta=-1.0)
    want = tsmm_ref(V, X, V.clone(), 0.5, -1.0)
    scale = 0.5 * (V.abs() @ X.abs()) + V.abs()
    _within(got, want, scale, m + 2, torch.float64)
    assert torch.equal(got, tsmm(V, X, V.clone(), 0.5, -1.0))


@pytest.mark.parametrize("b", [1, 4, 17])
@pytest.mark.parametrize("bs", [65, 128, 256, 500])
@pytest.mark.parametrize("tb,tx", [(torch.float64, torch.float64),
                                   (torch.complex128, torch.float64),
                                   (torch.complex64, torch.complex128),
                                   (torch.bfloat16, torch.float32)],
                         ids=["f64", "c128-f64", "c64-c128", "bf16-f32"])
def test_stream_block_diag_matches_plain(tb, tx, bs, b):
    """B4's stream past bs = 64 at an odd block count: within its bound of
    the plain version; a second call and operands one value off 16 bytes
    (filled value by value) give the same bits."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(bs * b)
    nb = 7
    blocks = _randn((nb, bs, bs), tb, g) if tb in WIDE else torch.randn(
        nb, bs, bs, generator=g, device="cuda").to(tb)
    x = _randn((nb * bs, b), tx, g)
    execution.reset_launch_counts()
    y = block_jacobi_apply(blocks, x)
    assert execution.launch_counts()["block_diag_matmul"] == 1
    out = torch.promote_types(tb, tx)
    assert y.dtype == out
    w = WIDE[out]
    want = block_diag_matmul_ref(blocks.to(w), x.to(w))
    scale = block_diag_matmul_ref(blocks.to(w).abs(), x.to(w).abs())
    _within(y, want, scale.real, bs, out)
    assert torch.equal(block_jacobi_apply(blocks, x), y)
    assert torch.equal(block_jacobi_apply(_shifted(blocks), _shifted(x)), y)


@pytest.mark.parametrize("b", [1, 4, 17])
@pytest.mark.parametrize("tb,tx,bs", [(torch.float64, torch.float64, 1700),
                                      (torch.complex128, torch.complex128,
                                       900),
                                      (torch.complex128, torch.float64, 900),
                                      (torch.complex64, torch.complex128,
                                       1500)],
                         ids=["f64", "c128", "c128-f64", "c64-c128"])
def test_tiled_block_diag_matches_plain(tb, tx, bs, b):
    """B4 past what the stream's stages hold in shared memory (bs past
    1,614 in float64, 807 in complex128, 854 for complex128 blocks on real
    x, 1,452 for complex64 blocks on complex128 x) takes
    ``block_diag_tiled``: within its bound of the plain version, and a
    second call gives the same bits."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(bs + b)
    nb = 3
    blocks = _randn((nb, bs, bs), tb, g)
    x = _randn((nb * bs, b), tx, g)
    execution.reset_launch_counts()
    y = block_jacobi_apply(blocks, x)
    assert execution.launch_counts()["block_diag_matmul"] == 1
    out = torch.promote_types(tb, tx)
    assert y.dtype == out
    w = WIDE[out]
    want = block_diag_matmul_ref(blocks.to(w), x.to(w))
    scale = block_diag_matmul_ref(blocks.to(w).abs(), x.to(w).abs())
    _within(y, want, scale.real, bs, out)
    assert torch.equal(block_jacobi_apply(blocks, x), y)


# ------------------------------------------------- mixed operand dtypes
#: (first operand, second operand): real widths, real with complex,
#: complex of two precisions (``tests/test_torch_mixed_dtypes.py`` holds
#: the same pairs against the JAX package on the CPU)
MIXED = [(torch.float64, torch.float32), (torch.float32, torch.float64),
         (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float16),
         (torch.float16, torch.float64), (torch.complex128, torch.float64),
         (torch.float64, torch.complex128), (torch.complex64, torch.float32),
         (torch.float32, torch.complex64), (torch.complex64, torch.complex128),
         (torch.complex128, torch.complex64), (torch.complex64, torch.float64),
         (torch.float64, torch.complex64), (torch.bfloat16, torch.complex64)]
MIXED_IDS = [f"{str(a)[6:]}-{str(b)[6:]}" for a, b in MIXED]


def _mixed_randn(shape, dtype, g):
    wide = torch.complex128 if dtype.is_complex else torch.float64
    return torch.randn(*shape, generator=g, device="cuda",
                       dtype=wide).to(dtype)


def _rel_within(got, want, out):
    """max |kernel - plain| at most 1e-12 (64-bit results) or 1e-5 (32-bit)
    of max |plain|, the plain version in the wide dtype."""
    tol = 1e-12 if out in (torch.float64, torch.complex128) else 1e-5
    err = float((got.to(want.dtype) - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


@pytest.mark.parametrize("m,k", [(16, 16), (96, 72)], ids=["16", "96x72"])
@pytest.mark.parametrize("vd,wd", MIXED, ids=MIXED_IDS)
def test_mixed_tsmttsm_on_card(vd, wd, m, k):
    need_card()
    g = torch.Generator(device="cuda").manual_seed(m + k)
    V, W = _mixed_randn((4099, m), vd, g), _mixed_randn((4099, k), wd, g)
    out = torch.promote_types(vd, wd)
    X = _mixed_randn((m, k), out, g)
    alpha, beta = (0.5 - 0.5j, 2.0j) if out.is_complex else (0.5, -2.0)
    w = WIDE.get(out, torch.float64)
    for kahan in (False, True):
        execution.reset_launch_counts()
        got = tsmttsm(V, W, X, alpha, beta, kahan=kahan)
        assert execution.launch_counts()["tsmttsm"] == 1
        assert got.dtype == out
        _rel_within(got, tsmttsm_ref(V.to(w), W.to(w), X.to(w), alpha,
                                     beta), out)


@pytest.mark.parametrize("m,k", [(16, 16), (96, 72)], ids=["16", "96x72"])
@pytest.mark.parametrize("vd,xd", MIXED, ids=MIXED_IDS)
def test_mixed_tsmm_on_card(vd, xd, m, k):
    need_card()
    g = torch.Generator(device="cuda").manual_seed(m * k)
    V, X = _mixed_randn((4099, m), vd, g), _mixed_randn((m, k), xd, g)
    out = torch.promote_types(vd, xd)
    W = _mixed_randn((4099, k), out, g)
    alpha, beta = (1.5j, 0.5) if out.is_complex else (1.5, 0.5)
    w = WIDE.get(out, torch.float64)
    execution.reset_launch_counts()
    got = tsmm(V, X, W, alpha, beta)
    assert execution.launch_counts()["tsmm"] == 1
    assert got.dtype == out
    _rel_within(got, tsmm_ref(V.to(w), X.to(w), W.to(w), alpha, beta), out)


@pytest.mark.parametrize("bs", [32, 128], ids=["bs32", "bs128"])
@pytest.mark.parametrize("bd,xd", MIXED, ids=MIXED_IDS)
def test_mixed_block_diag_on_card(bd, xd, bs):
    need_card()
    g = torch.Generator(device="cuda").manual_seed(bs)
    blocks, x = _mixed_randn((9, bs, bs), bd, g), _mixed_randn((9 * bs, 3),
                                                               xd, g)
    out = torch.promote_types(bd, xd)
    w = WIDE.get(out, torch.float64)
    execution.reset_launch_counts()
    y = block_jacobi_apply(blocks, x)
    assert execution.launch_counts()["block_diag_matmul"] == 1
    assert y.dtype == out
    _rel_within(y, block_diag_matmul_ref(blocks.to(w), x.to(w)), out)


#: B1: (the matrix' compute dtype, its stored dtype, x's dtype)
MIXED_B1 = [(torch.float64, torch.float64, torch.float32),
            (torch.float32, torch.float32, torch.float64),
            (torch.float32, torch.float32, torch.bfloat16),
            (torch.complex128, torch.complex128, torch.float64),
            (torch.float64, torch.float64, torch.complex128),
            (torch.complex64, torch.complex64, torch.float32),
            (torch.float32, torch.float32, torch.complex64),
            (torch.complex64, torch.complex64, torch.complex128),
            (torch.complex128, torch.complex128, torch.complex64),
            (torch.complex64, torch.complex64, torch.float64),
            (torch.float64, torch.float64, torch.complex64),
            (torch.float32, torch.float32, torch.complex128),
            (torch.float32, torch.bfloat16, torch.complex64),
            (torch.float32, torch.float16, torch.complex128),
            (torch.float32, torch.bfloat16, torch.float64)]


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("ct,st,xd", MIXED_B1,
                         ids=[f"{str(a)[6:]}-{str(s)[6:]}-{str(c)[6:]}"
                              for a, s, c in MIXED_B1])
def test_mixed_spmv_on_card(ct, st, xd, b):
    """Every fusion flag (complex coefficients where the result is
    complex), y and z in x's dtype, against the plain version on the same
    matrix; the dots in the result's dot dtype."""
    need_card()
    r, c, v, n = laplace3d(12)
    rng = np.random.default_rng(31)
    vals = np.asarray(v, np.float64)
    if ct.is_complex:
        vals = vals * np.exp(1j * rng.uniform(0, 2 * np.pi, vals.size))
    kw = dict(C=32, sigma=64, dtype=ct)
    if st != ct:
        kw["store_dtype"] = st
    A = from_coo(r, c, vals, (n, n), device="cuda", **kw)
    g = torch.Generator(device="cuda").manual_seed(b)
    x, y, z = (_mixed_randn((A.nrows_pad, b), xd, g) for _ in range(3))
    out = torch.promote_types(ct, xd)
    coefs = dict(alpha=0.5 - 0.25j, beta=-1.0 + 0.5j, gamma=0.25j,
                 delta=2.0, eta=0.5 + 1j) if out.is_complex else dict(
        alpha=0.5, beta=-1.0, gamma=0.25, delta=2.0, eta=0.5)
    for dots in (False, True):
        opts = SpmvOpts(**coefs, dot_yy=dots, dot_xy=dots, dot_xx=dots)
        execution.reset_launch_counts()
        gy, gz, gd = sellcs_spmv(A, x, y, z, opts)
        assert execution.launch_counts()["sellcs_spmv"] == 1
        assert gy.dtype == out and gz.dtype == out
        wy, wz, wd = sellcs_spmv_ref(A, x.to(out), y.to(out), z.to(out),
                                     opts)
        _rel_within(gy, wy, out)
        _rel_within(gz, wz, out)
        if dots:
            assert gd.dtype == wd.dtype
            _rel_within(gd, wd, out)


@pytest.mark.parametrize("dt", [torch.float32, torch.complex64],
                         ids=["float32", "complex64"])
def test_tsmttsm_column_blocks_on_card(dt, monkeypatch):
    """Past the shared-memory limit (here lowered, with the stage size, so
    that a call of 300 x 200 is past it) B2 runs as column blocks over
    the whole call's row partition: the same bits as the call that fits,
    with and without Kahan, within the plain version's bound."""
    need_card()
    from repro_torch.kernels import tsmttsm as b2
    g = torch.Generator(device="cuda").manual_seed(300)
    n, m, k = 4099, 300, 200
    V, W, X = (_mixed_randn(s, dt, g) for s in ((n, m), (n, k), (m, k)))
    alpha, beta = (0.5 - 0.5j, 2.0j) if dt.is_complex else (0.5, -2.0)
    whole = {kahan: tsmttsm(V, W, X, alpha, beta, kahan=kahan)
             for kahan in (False, True)}
    monkeypatch.setattr(b2, "STAGE_BYTES", 1024)
    monkeypatch.setattr(b2, "STAGE_LIMIT",
                        b2.stage_smem(m, k, dt.itemsize, dt) // 2)
    assert b2.column_blocks(m, k, dt.itemsize, dt) != (m, k)
    w = WIDE[dt]
    want = tsmttsm_ref(V.to(w), W.to(w), X.to(w), alpha, beta)
    for kahan in (False, True):
        execution.reset_launch_counts()
        got = tsmttsm(V, W, X, alpha, beta, kahan=kahan)
        assert execution.launch_counts()["tsmttsm"] > 1
        assert torch.equal(got, whole[kahan])
        _rel_within(got, want, dt)


@pytest.mark.parametrize("dt,width", [(torch.float32, 8400),
                                      (torch.complex64, 4200)],
                         ids=["float32", "complex64"])
def test_tsmttsm_past_the_shared_memory_limit(dt, width):
    """m + k past what three stages of one row can hold (16,640 values in
    float32, 8,320 in complex64): column blocks, against the plain
    version."""
    need_card()
    from repro_torch.kernels import tsmttsm as b2
    assert b2.column_blocks(width, width, dt.itemsize, dt) != (width, width)
    g = torch.Generator(device="cuda").manual_seed(width)
    V, W = (_mixed_randn((40, width), dt, g) for _ in range(2))
    w = WIDE[dt]
    got = tsmttsm(V, W, kahan=True)
    _rel_within(got, tsmttsm_ref(V.to(w), W.to(w)), dt)


def test_column_cg_complex_rhs_on_real_matrix_on_card():
    """Column CG with a complex128 right-hand side on a real float64
    laplace3d(12): the CPU's 49 iterations (within one: the sums run in
    another order), in complex128, through B1's real values under a
    complex compute dtype."""
    need_card()
    r, c, v, n = laplace3d(12)
    A = from_coo(r, c, v, (n, n), C=32, sigma=1, dtype=np.float64,
                 device="cuda")
    rng = np.random.default_rng(3)
    b = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
    execution.reset_launch_counts()
    res = cg(make_operator(A), A.permute(torch.from_numpy(b).cuda()),
             tol=1e-8, maxiter=2000)
    assert bool(res.converged.all()) and abs(res.iters - 49) <= 1
    assert res.x.dtype == torch.complex128
    assert execution.launch_counts()["sellcs_spmv"] >= res.iters
