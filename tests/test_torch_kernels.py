"""Kernel B1 (``kernels/csrc/sellcs_spmv.cu``) against its plain version
on the card, and the wrapper's refusals.

The ``gpu``-marked tests need an NVIDIA GPU with ``nvcc``; each decides
inside the test whether a card is present and skips with a reason when it
is not.  Run them on the card with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_*.py``.  Tolerances: max |kernel - plain| / max |plain|
at most 1e-12 for float64 compute, 1e-5 (vectors) and 1e-6 (float64 dots
of float32 vectors) for float32 compute — the two sum in other orders.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SpmvOpts, execution, from_coo
from repro_torch.kernels.ops import sellcs_spmv
from repro_torch.kernels.ref import sellcs_spmv_ref
from repro_torch.kernels.sellcs_spmv import MAX_C, sellcs_spmv_cuda
from repro_torch.matrices import matpde
from repro_torch.solvers import cg, make_operator

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
