"""Kernels B1 (``kernels/csrc/sellcs_spmv.cu``), B2 (``tsmttsm.cu``) and
B3 (``tsmm.cu``) against their plain versions on the card, and the
wrappers' refusals.

The ``gpu``-marked tests need an NVIDIA GPU with ``nvcc``; each decides
inside the test whether a card is present and skips with a reason when it
is not.  Run them on the card with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_*.py``.  Tolerances: max |kernel - plain| / max |plain|
at most 1e-12 for float64 compute, 1e-5 (vectors) and 1e-6 (float64 dots
of float32 vectors) for float32 compute — the two sum in other orders.
The tall-skinny kernels are held to their plain version computed in
float64 from the same inputs, within ``TSM_TOL`` times the dot-product
scale ``|V|^T |W|`` (or ``|V| |X|``): the kernel sums in its
accumulation dtype in another order.  With Kahan, the float32-accumulated
cases are held to the compensated bound ``KAHAN_TOL``, and over 2^20 rows
the compensated error must be well below the plain sum's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SpmvOpts, execution, from_coo
from repro_torch.kernels.ops import sellcs_spmv, tsmm, tsmttsm
from repro_torch.kernels.ref import sellcs_spmv_ref, tsmm_ref, tsmttsm_ref
from repro_torch.kernels.sellcs_spmv import MAX_C, sellcs_spmv_cuda
from repro_torch.kernels.tsmm import tsmm_cuda
from repro_torch.kernels.tsmttsm import MAX_DIM, tsmttsm_cuda
from repro_torch.matrices import anisotropic_laplace2d, matpde
from repro_torch.solvers import cg, cg_init, cg_step, make_operator

PAIRS = [(torch.float64, np.float64), (torch.float32, np.float32),
         (torch.bfloat16, np.float32), (torch.float16, np.float32),
         (torch.float32, np.float64)]
FLAGS = {
    "plain": (dict(), False, False),
    "alpha_beta": (dict(alpha=0.7, beta=-1.3), True, False),
    "gamma_scalar": (dict(gamma=0.25), False, False),
    "gamma_column": (dict(gamma="column"), True, False),
    "chain": (dict(alpha=1.1, beta=0.5, delta=0.3, eta=-0.8), True, True),
    "dots": (dict(dot_yy=True, dot_xy=True, dot_xx=True), True, False),
}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _matrix(n=300, ncols=None, seed=0, **kw):
    rng = np.random.default_rng(seed)
    ncols = n if ncols is None else ncols
    rowlen = rng.integers(0, 20, n)
    rows = np.repeat(np.arange(n), rowlen)
    cols = rng.integers(0, ncols, rows.size)
    return from_coo(rows, cols, rng.standard_normal(rows.size), (n, ncols),
                    **kw)


def rel_err(got, want):
    if want is None:
        assert got is None
        return 0.0
    want = want.double()
    scale = want.abs().max().item() if want.numel() else 0.0
    diff = (got.double() - want).abs().max().item() if want.numel() else 0.0
    return diff / scale if scale else diff


@pytest.mark.gpu
@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("b", [1, 3, 16, 20])
@pytest.mark.parametrize("store,np_ct", PAIRS,
                         ids=[f"{s}-{np.dtype(c).name}" for s, c in PAIRS])
def test_kernel_matches_plain_on_card(store, np_ct, b, flag):
    need_card()
    kw, with_y, with_z = FLAGS[flag]
    A = _matrix(C=32, sigma=128, dtype=np_ct, store_dtype=store,
                device="cuda")
    ct = A.dtype
    g = torch.Generator(device="cuda").manual_seed(b)
    x, y, z = (torch.randn(A.nrows_pad, b, dtype=ct, device="cuda",
                           generator=g) for _ in range(3))
    kw = dict(kw)
    if kw.get("gamma") == "column":
        kw["gamma"] = torch.linspace(-1, 1, b, dtype=ct, device="cuda")
    opts = SpmvOpts(**kw)
    args = (A, x, y if with_y else None, z if with_z else None, opts)
    execution.reset_launch_counts()
    got = sellcs_spmv(*args)
    assert execution.launch_counts()["sellcs_spmv"] == 1
    want = sellcs_spmv_ref(*args)
    torch.cuda.synchronize()
    vec_tol, dot_tol = (1e-12, 1e-12) if ct == torch.float64 else (1e-5, 1e-6)
    assert rel_err(got[0], want[0]) <= vec_tol
    assert rel_err(got[1], want[1]) <= vec_tol
    assert rel_err(got[2], want[2]) <= dot_tol


@pytest.mark.gpu
def test_kernel_rectangular_part_on_card():
    need_card()
    A = _matrix(n=200, ncols=75, C=32, sigma=64, dtype=np.float64,
                device="cuda")
    x = torch.randn(75, 4, dtype=torch.float64, device="cuda")
    opts = SpmvOpts(alpha=2.0, dot_yy=True)
    got, want = sellcs_spmv(A, x, opts=opts), sellcs_spmv_ref(A, x, opts=opts)
    assert rel_err(got[0], want[0]) <= 1e-12
    assert rel_err(got[2], want[2]) <= 1e-12
    with pytest.raises(ValueError, match="square"):
        sellcs_spmv(A, x, opts=SpmvOpts(dot_xy=True))


@pytest.mark.gpu
def test_kernel_dots_are_deterministic_on_card():
    need_card()
    A = _matrix(n=5000, C=32, sigma=256, dtype=np.float32, device="cuda")
    x = torch.randn(A.nrows_pad, 4, device="cuda")
    opts = SpmvOpts(dot_yy=True, dot_xy=True, dot_xx=True)
    first = sellcs_spmv(A, x, opts=opts)
    for _ in range(5):
        again = sellcs_spmv(A, x, opts=opts)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[2], first[2])


@pytest.mark.gpu
def test_case_study_on_card_launches_once_per_iteration():
    need_card()
    r, c, v, n = matpde(16, beta_c=0.0)
    A = from_coo(r, c, v, (n, n), C=16, sigma=32, w_align=4,
                 dtype=np.float32)
    b = np.random.default_rng(0).standard_normal((n, 2)).astype(np.float32)
    execution.reset_launch_counts()
    res = cg(make_operator(A), A.permute(b), tol=1e-6, maxiter=600)
    assert bool(res.converged.all())
    assert abs(res.iters - 53) <= 1
    assert execution.launch_counts()["sellcs_spmv"] == res.iters + 1


@pytest.mark.gpu
def test_wrapper_refusals_on_card():
    need_card()
    A = _matrix(C=32, sigma=32, dtype=np.float32, device="cuda")
    x = torch.randn(A.nrows_pad, 2, device="cuda")
    with pytest.raises(TypeError, match="must be torch.float32"):
        sellcs_spmv(A, x.double())
    with pytest.raises(NotImplementedError, match="complex"):
        sellcs_spmv(A, x.to(torch.complex64))
    with pytest.raises(ValueError, match="on cpu"):
        sellcs_spmv_cuda(A.vals.cpu(), A.cols, A.chunk_off, A.chunk_len, x,
                         C=32)
    with pytest.raises(ValueError, match="contiguous"):
        sellcs_spmv_cuda(A.vals, A.cols, A.chunk_off, A.chunk_len,
                         torch.randn(2, A.nrows_pad, device="cuda").T, C=32)
    with pytest.raises(ValueError, match="outside"):
        sellcs_spmv_cuda(A.vals, A.cols, A.chunk_off, A.chunk_len, x,
                         C=MAX_C + 1)


def test_wrapper_refuses_cpu_tensors():
    A = _matrix(C=8, sigma=8, dtype=np.float64, device="cpu")
    x = torch.zeros(A.nrows_pad, 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sellcs_spmv_cuda(A.vals, A.cols, A.chunk_off, A.chunk_len, x, C=8)


# ------------------------------------------------- tall-skinny kernels
#: error bound per unit of |V|^T |W| (or |V| |X|): the accumulation
#: dtype's eps times a few (float32 for the half types, whose inputs are
#: exact in float32, so only the sums round)
TSM_TOL = {torch.float64: 1e-13, torch.float32: 1e-5,
           torch.bfloat16: 1e-5, torch.float16: 1e-5}
#: the compensated bound of the Kahan kernel, per unit of |V|^T |W|: an
#: 8-row group summed plainly (8u with the products), three compensated
#: levels (groups, lanes, blocks) at 2u each, alpha/beta and the result
#: (3u); float64 keeps TSM_TOL, the float64 plain version's own sum being
#: no more accurate than that
KAHAN_TOL = {torch.float64: 1e-13, torch.float32: 17 * 2.0 ** -24,
             torch.bfloat16: 17 * 2.0 ** -24, torch.float16: 17 * 2.0 ** -24}
#: the output's own rounding on top (bfloat16 / float16 results)
OUT_EPS = {torch.float64: 0.0, torch.float32: 0.0, torch.bfloat16: 2 ** -8,
           torch.float16: 2 ** -11}


def _tsm_inputs(n, m, k, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(*shape, generator=g, device="cuda",
                             dtype=torch.float64).to(dtype)
                 for shape in ((n, m), (n, k), (m, k)))


def _within(got, want, scale, dtype, tol=TSM_TOL):
    lim = tol[dtype] * scale + OUT_EPS[dtype] * want.abs()
    assert bool(((got.double() - want).abs() <= lim + 1e-300).all())


@pytest.mark.gpu
@pytest.mark.parametrize("with_x", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
@pytest.mark.parametrize("n,m,k", [(0, 3, 8), (1, 1, 1), (37, 3, 8),
                                   (4109, 16, 16), (4109, MAX_DIM, MAX_DIM),
                                   (70001, 8, 3)])
@pytest.mark.parametrize("dtype", list(TSM_TOL),
                         ids=lambda d: str(d).split(".")[-1])
def test_tsmttsm_matches_plain_on_card(dtype, n, m, k, kahan, with_x):
    need_card()
    V, W, X = _tsm_inputs(n, m, k, dtype, n + m)
    ab = dict(alpha=0.5, beta=-2.0) if with_x else dict(alpha=1.5)
    execution.reset_launch_counts()
    got = tsmttsm(V, W, X if with_x else None, kahan=kahan, **ab)
    assert execution.launch_counts()["tsmttsm"] == 1
    assert got.dtype == dtype and got.shape == (m, k)
    Vd, Wd, Xd = V.double(), W.double(), X.double()
    want = tsmttsm_ref(Vd, Wd, Xd if with_x else None, **ab)
    scale = abs(ab["alpha"]) * (Vd.abs().T @ Wd.abs()) + 2.0 * Xd.abs()
    _within(got, want, scale, dtype, KAHAN_TOL if kahan else TSM_TOL)
    again = tsmttsm(V, W, X if with_x else None, kahan=kahan, **ab)
    assert torch.equal(got, again)                 # no atomics


@pytest.mark.gpu
def test_tsmttsm_kahan_beats_plain_sum_on_card():
    """float32 over 2^20 rows, pooled over four (m, k): the compensated
    kernel's rms error is at most half the plain sum's on the same inputs
    (a float32 emulation of the kernel's order gives about a quarter; a
    kernel that ignored ``kahan`` would give 1)."""
    need_card()
    errs = {False: [], True: []}
    for m, k in ((1, 1), (3, 8), (16, 16), (MAX_DIM, MAX_DIM)):
        V, W, _ = _tsm_inputs(1 << 20, m, k, torch.float32, m + k)
        Vd, Wd = V.double(), W.double()
        want = tsmttsm_ref(Vd, Wd)
        for kahan in (False, True):
            got = tsmttsm(V, W, kahan=kahan)
            errs[kahan].append((got.double() - want).flatten())
        _within(got, want, Vd.abs().T @ Wd.abs(), torch.float32, KAHAN_TOL)
    rms = {kh: float(torch.cat(e).square().mean().sqrt())
           for kh, e in errs.items()}
    assert rms[True] <= 0.5 * rms[False]


@pytest.mark.gpu
@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("n,m,k", [(1, 1, 1), (37, 3, 8), (4109, 16, 16),
                                   (4109, MAX_DIM, MAX_DIM), (70001, 8, 3)])
@pytest.mark.parametrize("dtype", list(TSM_TOL),
                         ids=lambda d: str(d).split(".")[-1])
def test_tsmm_matches_plain_on_card(dtype, n, m, k, with_w):
    need_card()
    V, W, _ = _tsm_inputs(n, m, k, dtype, n + k)
    X = _tsm_inputs(1, m, k, dtype, 7)[2]
    ab = dict(alpha=0.5, beta=-2.0) if with_w else dict(alpha=1.5)
    execution.reset_launch_counts()
    got = tsmm(V, X, W if with_w else None, **ab)
    assert execution.launch_counts()["tsmm"] == 1
    assert got.dtype == dtype and got.shape == (n, k)
    Vd, Wd, Xd = V.double(), W.double(), X.double()
    want = tsmm_ref(Vd, Xd, Wd if with_w else None, **ab)
    scale = abs(ab["alpha"]) * (Vd.abs() @ Xd.abs()) + 2.0 * Wd.abs()
    _within(got, want, scale, dtype)


@pytest.mark.gpu
def test_tsm_wrapper_refusals_on_card():
    need_card()
    V, W, X = _tsm_inputs(100, 4, 4, torch.float32, 0)
    with pytest.raises(TypeError, match="must be torch.float32"):
        tsmttsm_cuda(V, W.double())
    with pytest.raises(ValueError, match="outside"):
        tsmttsm_cuda(torch.zeros(10, MAX_DIM + 1, device="cuda"),
                     torch.zeros(10, 2, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        tsmm_cuda(torch.zeros(4, 100, device="cuda").T, X)
    with pytest.raises(TypeError, match="no wider"):
        tsmm_cuda(V, X.double())
    with pytest.raises(NotImplementedError, match="complex"):
        tsmttsm(V.to(torch.complex64), W.to(torch.complex64))
    with pytest.raises(ValueError, match="beta"):
        tsmm(V, X, None, 1.0, 2.0)


def test_tsm_wrappers_refuse_cpu_tensors():
    V = torch.zeros(10, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsmttsm_cuda(V, V)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsmm_cuda(V, torch.zeros(2, 2))


@pytest.mark.gpu
def test_block_cg_iteration_launches_each_kernel():
    """One BCGrQ iteration on the card is one SpMV, two tsmttsm and four
    tsmm launches (three with an output operand, one in SVQB); init is one
    SpMV, one tsmttsm and one tsmm."""
    need_card()
    r, c, v, n = anisotropic_laplace2d(32, epsilon=1e-2)
    A = from_coo(r, c, v, (n, n), C=16, sigma=1, w_align=4, dtype=np.float64)
    b = np.random.default_rng(7).standard_normal((n, 16))
    op = make_operator(A)
    names = ("sellcs_spmv", "tsmttsm", "tsmm")

    def counts():
        got = execution.launch_counts()
        return tuple(got.get(k, 0) for k in names)

    execution.reset_launch_counts()
    st = cg_init(op, A.permute(b), tol=1e-8, maxiter=400, block=True)
    assert counts() == (1, 1, 1)
    execution.reset_launch_counts()
    st = cg_step(op, st, 5)
    assert st.it == 5
    assert counts() == (5, 10, 20)
    res = cg(op, A.permute(b), tol=1e-8, maxiter=400, block=True)
    col = cg(op, A.permute(b), tol=1e-8, maxiter=400)
    assert bool(res.converged.all()) and res.iters <= col.iters
