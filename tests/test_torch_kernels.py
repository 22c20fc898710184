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
from repro_torch.kernels.sellcs_spmv import (DOT_CHUNKS,
                                             MAX_THREADS, dot_parts,
                                             launch_geometry,
                                             sellcs_spmv_cuda)
from repro_torch.kernels.tsmm import tsmm_cuda
from repro_torch.kernels.tsmttsm import (MAX_BLOCKS, STAGE_BYTES,
                                         block_runs, bulk_aligned,
                                         row_partition, stage_bytes,
                                         stage_rows,
                                         summation_depth, thread_tile,
                                         tsmttsm_cuda)
from repro_torch.matrices import anisotropic_laplace2d, matpde
from repro_torch.solvers import (cg, cg_finalize, cg_init, cg_step,
                                 make_operator)

#: the widest m, k of B2's and B3's narrow designs (wider calls take the
#: wide instances, tests/test_torch_wide_card.py)
NARROW = 64
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


def _complex_matrix(np_ct, n=300, seed=0, **kw):
    """A random ragged matrix with complex values, on the card."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), rng.integers(0, 20, n))
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size) + 1j * rng.standard_normal(rows.size)
    return from_coo(rows, cols, vals, (n, n), dtype=np_ct, device="cuda",
                    **kw)


def complex_rel_err(got, want):
    """max |got - want| / max |want| in complex128."""
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    scale = want.abs().max().item() if want.numel() else 0.0
    diff = (got - want).abs().max().item() if want.numel() else 0.0
    return diff / scale if scale else diff


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
@pytest.mark.parametrize("b", [1, 2, 3, 4, 8, 16, 20])
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


CX_FLAGS = {
    "plain": (dict(), False, False),
    "alpha_beta": (dict(alpha=0.7 - 0.2j, beta=-1.3 + 0.4j), True, False),
    "gamma_scalar": (dict(alpha=1.2 + 0.5j, gamma=0.25 - 0.75j), False,
                     False),
    "gamma_column": (dict(gamma="column"), True, False),
    "chain": (dict(alpha=1.1j, beta=0.5, delta=0.3 - 0.1j, eta=-0.8 + 0.6j),
              True, True),
    "dots": (dict(alpha=0.9 + 0.1j, dot_yy=True, dot_xy=True, dot_xx=True),
             True, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("real_x", [False, True])
@pytest.mark.parametrize("flag", list(CX_FLAGS))
@pytest.mark.parametrize("b", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("np_ct", [np.complex128, np.complex64],
                         ids=["complex128", "complex64"])
def test_complex_kernel_matches_plain_on_card(np_ct, b, flag, real_x):
    """Complex values launch B1 with every fusion flag and complex
    coefficients (a real x converted exactly), within the real kernels'
    tolerances of the plain version."""
    need_card()
    kw, with_y, with_z = CX_FLAGS[flag]
    A = _complex_matrix(np_ct, C=32, sigma=128)
    ct = A.dtype
    rt = torch.float64 if ct == torch.complex128 else torch.float32
    g = torch.Generator(device="cuda").manual_seed(b)
    x = torch.randn(A.nrows_pad, b, dtype=rt if real_x else ct,
                    device="cuda", generator=g)
    y, z = (torch.randn(A.nrows_pad, b, dtype=ct, device="cuda",
                        generator=g) for _ in range(2))
    kw = dict(kw)
    if kw.get("gamma") == "column":
        kw["gamma"] = torch.linspace(-1, 1, b, dtype=rt, device="cuda") * 1j
    opts = SpmvOpts(**kw)
    args = (A, x, y if with_y else None, z if with_z else None, opts)
    execution.reset_launch_counts()
    got = sellcs_spmv(*args)
    assert execution.launch_counts()["sellcs_spmv"] == 1
    want = sellcs_spmv_ref(*args)
    torch.cuda.synchronize()
    assert got[0].dtype == ct
    vec_tol, dot_tol = (1e-12, 1e-12) if ct == torch.complex128 else (1e-5,
                                                                      1e-6)
    assert complex_rel_err(got[0], want[0]) <= vec_tol
    if with_z:
        assert complex_rel_err(got[1], want[1]) <= vec_tol
    if want[2] is not None:
        assert got[2].dtype == torch.complex128
        assert complex_rel_err(got[2], want[2]) <= dot_tol


@pytest.mark.gpu
@pytest.mark.parametrize("with_x", [False, True])
@pytest.mark.parametrize("kahan", [False, True])
@pytest.mark.parametrize("conj", [True, False])
@pytest.mark.parametrize("n,m,k", [(37, 3, 8), (4109, 16, 16),
                                   (4109, 64, 64),
                                   (4109, 64, 16), (4109, 5, 64),
                                   (37, 64, 1)])
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64],
                         ids=["complex128", "complex64"])
def test_complex_tsm_matches_plain_on_card(dtype, n, m, k, conj, kahan,
                                           with_x):
    """Complex B2 (V^H W with conj, V^T W without; with and without
    Kahan) and B3 (complex and real X) against their plain versions in
    complex128."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(n + m + k)
    V, W, X = (torch.randn(*s, generator=g, device="cuda",
                           dtype=torch.complex128).to(dtype)
               for s in ((n, m), (n, k), (m, k)))
    Vd, Wd, Xd = (t.to(torch.complex128) for t in (V, W, X))
    ab = dict(alpha=0.5 - 0.5j, beta=-2.0 + 1.0j) if with_x else dict(
        alpha=1.5j)
    tol = 1e-12 if dtype == torch.complex128 else 1e-5
    execution.reset_launch_counts()
    got = tsmttsm(V, W, X if with_x else None, kahan=kahan, conj=conj, **ab)
    assert execution.launch_counts()["tsmttsm"] == 1
    assert got.dtype == dtype and got.shape == (m, k)
    want = tsmttsm_ref(Vd, Wd, Xd if with_x else None, conj=conj, **ab)
    assert complex_rel_err(got, want) <= tol
    Xs = X if kahan else X.real.contiguous()   # complex and real X for B3
    W2 = torch.randn(n, k, generator=g, device="cuda",
                     dtype=torch.complex128).to(dtype)
    got = tsmm(V, Xs, W2 if with_x else None, **ab)
    assert execution.launch_counts()["tsmm"] == 1
    want = tsmm_ref(Vd, Xs.to(torch.complex128),
                    W2.to(torch.complex128) if with_x else None, **ab)
    assert got.dtype == dtype
    assert complex_rel_err(got, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("kahan", [False, True])
@pytest.mark.parametrize("m,k", [(16, 16), (5, 16), (64, 3)])
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64],
                         ids=["complex128", "complex64"])
def test_complex_tsmttsm_views_and_chunks_give_the_same_bits_on_card(
        dtype, m, k, kahan):
    """Complex B2 on views one value past their allocation (complex64:
    off a 16-byte boundary, so the stages fill by plain loads) equals the
    same values in fresh tensors to the bit, and so does every call: the
    row partition alone fixes the order of the sums."""
    need_card()
    n = 262144 + 37
    g = torch.Generator(device="cuda").manual_seed(m + 3 * k)
    V, W = (torch.randn(n * w + 1, generator=g, device="cuda",
                        dtype=torch.complex128).to(dtype)[1:].view(n, w)
            for w in (m, k))
    want = tsmttsm(V.clone(), W.clone(), kahan=kahan)
    assert torch.equal(tsmttsm(V, W, kahan=kahan), want)
    assert torch.equal(tsmttsm(V.clone(), W.clone(), kahan=kahan), want)


@pytest.mark.gpu
@pytest.mark.parametrize("np_ct", [np.complex128, np.complex64],
                         ids=["complex128", "complex64"])
def test_complex_block_cg_chunked_equals_monolithic_on_card(np_ct):
    """Complex block CG (B1, B2, B3 on its path) in cg_step chunks equals
    one monolithic solve bit for bit."""
    need_card()
    A = anisotropic_laplace2d_complex(np_ct)
    op = make_operator(A)
    g = torch.Generator(device="cuda").manual_seed(7)
    b = torch.randn(A.nrows_pad, 16, generator=g, device="cuda",
                    dtype=torch.complex128).to(A.dtype)
    tol = 1e-10 if np_ct is np.complex128 else 1e-5
    res = cg(op, b, tol=tol, maxiter=400, block=True)
    st = cg_init(op, b, tol=tol, maxiter=400, block=True)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = cg_step(op, st, 3)
    ch = cg_finalize(st)
    assert bool(res.converged.all())
    assert ch.iters == res.iters and torch.equal(ch.x, res.x)


def anisotropic_laplace2d_complex(np_ct, nx=48):
    """anisotropic_laplace2d(nx) with U(1) phases on its off-diagonals
    (Hermitian positive definite), on the card."""
    r, c, v, n = anisotropic_laplace2d(nx, epsilon=0.1)
    r, c = np.asarray(r), np.asarray(c)
    up = r < c
    theta = np.zeros(r.size)
    theta[up] = np.random.default_rng(5).uniform(0, 2 * np.pi, int(up.sum()))
    key = {(int(i), int(j)): t for i, j, t in zip(r[up], c[up], theta[up])}
    lo = np.nonzero(r > c)[0]
    theta[lo] = [-key[(int(c[i]), int(r[i]))] for i in lo]
    return from_coo(r, c, np.asarray(v) * np.exp(1j * theta), (n, n), C=32,
                    sigma=1, dtype=np_ct, device="cuda")


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
@pytest.mark.parametrize("C", [8, 128, 256])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("np_ct", [np.float64, np.float32, np.complex128,
                                   np.complex64])
def test_kernel_passes_and_unaligned_operands_on_card(np_ct, aligned, C):
    """A chunk of C rows at b=16 takes C * tpr threads, walked in passes
    above 512; operands off a 16-byte boundary (views one value into a
    buffer) take the one-column-a-thread path.  Every flag at once, with
    complex coefficients for complex values."""
    need_card()
    cx = np.dtype(np_ct).kind == "c"
    n_rows = 5 * C + 3
    A = (_complex_matrix(np_ct, n=n_rows, C=C, sigma=4 * C) if cx else
         _matrix(n=n_rows, C=C, sigma=4 * C, dtype=np_ct, device="cuda"))
    ct, b, n = A.dtype, 16, A.nrows_pad
    g = torch.Generator(device="cuda").manual_seed(C)
    x, y, z = (torch.randn(n * b + 1, dtype=ct, device="cuda",
                           generator=g)[int(not aligned):][:n * b].view(n, b)
               for _ in range(3))
    # a complex128 value is 16 bytes: a view one value in stays aligned
    assert (x.data_ptr() % 16 == 0) == (aligned or x.element_size() == 16)
    unit = 1 - 0.4j if cx else 1.0
    opts = SpmvOpts(alpha=1.1 * unit, beta=0.5, delta=0.3 * unit, eta=-0.8,
                    gamma=torch.linspace(-1, 1, b, dtype=ct, device="cuda")
                    * unit, dot_yy=True, dot_xy=True, dot_xx=True)
    got = sellcs_spmv(A, x, y, z, opts)
    want = sellcs_spmv_ref(A, x, y, z, opts)
    err = complex_rel_err if cx else rel_err
    vec_tol, dot_tol = ((1e-12, 1e-12)
                        if ct in (torch.float64, torch.complex128)
                        else (1e-5, 1e-6))
    assert err(got[0], want[0]) <= vec_tol
    assert err(got[1], want[1]) <= vec_tol
    assert err(got[2], want[2]) <= dot_tol


@pytest.mark.gpu
@pytest.mark.parametrize("flag", list(CX_FLAGS))
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("np_ct", [np.complex128, np.complex64],
                         ids=["complex128", "complex64"])
def test_complex_kernel_tall_chunks_match_plain_on_card(np_ct, C, b, flag):
    """Chunks of 128 and 256 rows with complex values, each fusion flag
    alone: more rows than a block's threads, walked in passes, and with
    dots the shared memory a block needs above 48 KB (complex64 at 512
    threads)."""
    need_card()
    kw, with_y, with_z = CX_FLAGS[flag]
    A = _complex_matrix(np_ct, n=5 * C + 3, C=C, sigma=4 * C)
    ct = A.dtype
    rt = torch.float64 if ct == torch.complex128 else torch.float32
    g = torch.Generator(device="cuda").manual_seed(C + b)
    x, y, z = (torch.randn(A.nrows_pad, b, dtype=ct, device="cuda",
                           generator=g) for _ in range(3))
    kw = dict(kw)
    if kw.get("gamma") == "column":
        kw["gamma"] = torch.linspace(-1, 1, b, dtype=rt, device="cuda") * 1j
    opts = SpmvOpts(**kw)
    args = (A, x, y if with_y else None, z if with_z else None, opts)
    got, want = sellcs_spmv(*args), sellcs_spmv_ref(*args)
    vec_tol, dot_tol = (1e-12, 1e-12) if ct == torch.complex128 else (1e-5,
                                                                      1e-6)
    assert complex_rel_err(got[0], want[0]) <= vec_tol
    if with_z:
        assert complex_rel_err(got[1], want[1]) <= vec_tol
    if want[2] is not None:
        assert complex_rel_err(got[2], want[2]) <= dot_tol


@pytest.mark.gpu
@pytest.mark.parametrize("np_ct", [np.float32, np.complex128, np.complex64],
                         ids=["float32", "complex128", "complex64"])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_kernel_dots_are_deterministic_on_card(np_ct, b):
    need_card()
    A = _matrix(n=5000, C=32, sigma=256, dtype=np_ct, device="cuda")
    x = torch.randn(A.nrows_pad, b, device="cuda", dtype=A.dtype)
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
    # run_chunk enqueues one iteration past the last and drops it
    dropped = execution.discarded_counts().get("cg", 0)
    assert dropped == 1
    assert execution.launch_counts()["sellcs_spmv"] == res.iters + dropped + 1


@pytest.mark.gpu
def test_wrapper_refusals_on_card():
    need_card()
    A = _matrix(C=32, sigma=32, dtype=np.float32, device="cuda")
    x = torch.randn(A.nrows_pad, 2, device="cuda")
    # the kernel's wrapper takes x in the compute dtype it is given ...
    with pytest.raises(TypeError, match="must be torch.float32"):
        sellcs_spmv_cuda(A.vals, A.cols, A.chunk_off, A.chunk_len,
                         x.double(), C=32, compute_dtype=A.dtype)
    # ... and the op launches it for the pairs it once refused (float64 x,
    # complex x on real values) in the JAX op's result dtype, held against
    # the plain version
    for xd in (torch.float64, torch.complex64):
        execution.reset_launch_counts()
        got = sellcs_spmv(A, x.to(xd), opts=SpmvOpts(dot_xy=True))
        assert execution.launch_counts()["sellcs_spmv"] == 1
        assert got[0].dtype == xd
        want = sellcs_spmv_ref(A, x.to(xd), opts=SpmvOpts(dot_xy=True))
        assert complex_rel_err(got[0], want[0]) <= (
            1e-12 if xd == torch.float64 else 1e-5)
    # complex values launch the kernel (held against the plain version)
    Ac = _complex_matrix(np.complex64, C=32, sigma=32)
    xc = torch.randn(Ac.nrows_pad, 2, dtype=torch.complex64, device="cuda")
    execution.reset_launch_counts()
    got = sellcs_spmv(Ac, xc, opts=SpmvOpts(alpha=0.5j, dot_xy=True))
    assert execution.launch_counts()["sellcs_spmv"] == 1
    want = sellcs_spmv_ref(Ac, xc, opts=SpmvOpts(alpha=0.5j, dot_xy=True))
    assert complex_rel_err(got[0], want[0]) <= 1e-5
    assert complex_rel_err(got[2], want[2]) <= 1e-6
    with pytest.raises(ValueError, match="on cpu"):
        sellcs_spmv_cuda(A.vals.cpu(), A.cols, A.chunk_off, A.chunk_len, x,
                         C=32)
    with pytest.raises(ValueError, match="contiguous"):
        sellcs_spmv_cuda(A.vals, A.cols, A.chunk_off, A.chunk_len,
                         torch.randn(2, A.nrows_pad, device="cuda").T, C=32)
    # a chunk taller than the old limit of 256 rows (here one chunk of all
    # rows, ELLPACK) spreads over several blocks, held against the plain
    # version, dots included
    Ae = _matrix(C=A.nrows_pad, sigma=1, dtype=np.float32, device="cuda")
    assert Ae.C > 256 and Ae.nchunks == 1
    xe = torch.randn(Ae.nrows_pad, 2, device="cuda")
    opts = SpmvOpts(dot_yy=True, dot_xy=True)
    execution.reset_launch_counts()
    got = sellcs_spmv(Ae, xe, opts=opts)
    assert execution.launch_counts()["sellcs_spmv"] == 1
    want = sellcs_spmv_ref(Ae, xe, opts=opts)
    assert rel_err(got[0], want[0]) <= 1e-5
    assert rel_err(got[2], want[2]) <= 1e-6


def test_launch_geometry_spreads_rows_over_vector_threads():
    """b=16 in float64: 8 threads a row, each one double2, 4 rows a warp;
    b=4: two threads a row; b=1: one (as a plain SELL-C kernel)."""
    f64, f32 = torch.float64, torch.float32
    assert launch_geometry(16, 32, f64) == (16, 2, 8, 256, 1)
    assert launch_geometry(4, 32, f64) == (4, 2, 2, 64, 1)
    assert launch_geometry(1, 32, f64) == (1, 1, 1, 32, 1)
    assert launch_geometry(16, 32, f32) == (16, 4, 4, 128, 1)
    assert launch_geometry(4, 32, f32) == (4, 4, 1, 32, 1)
    # odd widths and operands off a 16-byte boundary: one column a thread
    assert launch_geometry(3, 32, f64) == (4, 1, 4, 128, 1)
    assert launch_geometry(16, 32, f64, vectors=False) == (16, 1, 16, 512, 1)
    # C * tpr above MAX_THREADS: the chunk spreads over blocks of
    # MAX_THREADS threads (chunk_parts)
    assert launch_geometry(16, 256, f64) == (16, 2, 8, MAX_THREADS, 1)
    assert launch_geometry(20, 32, f64) == (16, 2, 8, 256, 2)


def test_launch_geometry_gives_complex_values_their_own_widths():
    """Complex values without dots: 32 bytes of columns a thread (2
    complex128, 4 complex64); with dots, or where b does not allow, 16
    bytes or one column."""
    c128, c64 = torch.complex128, torch.complex64
    assert launch_geometry(16, 32, c128) == (16, 2, 8, 256, 1)
    assert launch_geometry(16, 32, c128, dots=True) == (16, 1, 16, 512, 1)
    assert launch_geometry(4, 32, c128, dots=True) == (4, 1, 4, 128, 1)
    assert launch_geometry(8, 32, c64) == (8, 4, 2, 64, 1)
    assert launch_geometry(4, 32, c64, dots=True) == (4, 2, 2, 64, 1)
    assert launch_geometry(6, 32, c64) == (8, 2, 4, 128, 1)
    assert launch_geometry(3, 32, c128) == (4, 1, 4, 128, 1)
    assert launch_geometry(16, 32, c128, vectors=False) == (16, 1, 16, 512, 1)
    # real values keep 16 bytes, dots or not
    assert launch_geometry(16, 32, torch.float64, dots=True) == (
        launch_geometry(16, 32, torch.float64))


def test_dot_parts_one_a_block_of_complex_chunks():
    """Real and complex values alike: one row of partials a block of
    DOT_CHUNKS chunks."""
    assert dot_parts(128000) == 128000 // DOT_CHUNKS
    assert dot_parts(5) == -(-5 // DOT_CHUNKS)
    assert dot_parts(1) == 1


@pytest.mark.parametrize("dots", [False, True])
@pytest.mark.parametrize("ct", [torch.float64, torch.float32,
                                torch.complex128, torch.complex64],
                         ids=["float64", "float32", "complex128",
                              "complex64"])
def test_launch_geometry_is_what_the_kernel_takes(ct, dots):
    # the kernel takes one column, 16 bytes of columns or, complex values
    # without dots, 32
    widths = (16, 32) if ct.is_complex and not dots else (16,)
    for b in range(1, 41):
        for C in (1, 8, 31, 32, 100, 256):
            for vectors in (True, False):
                g = launch_geometry(b, C, ct, vectors, dots)
                assert g.bw in (1, 2, 4, 8, 16) and g.tpr * g.cpt == g.bw
                assert g.cpt == 1 or (vectors and b % g.cpt == 0
                                      and g.cpt * ct.itemsize in widths)
                assert 32 % g.tpr == 0 and g.threads % 32 == 0
                assert min(C * g.tpr, MAX_THREADS) <= g.threads <= MAX_THREADS
                assert g.bw * (g.slices - 1) < b <= g.bw * g.slices
                assert g.bw >= min(b, 16)


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
#: (3u); the finishing kernel now sums the blocks in runs, a fourth level,
#: and the test keeps the three levels' bound, the tighter one; float64
#: keeps TSM_TOL, the float64 plain version's own sum being no more
#: accurate than that
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
                                   (4109, 16, 16), (4109, NARROW, NARROW),
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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_tsmttsm_kahan_at_the_block_cg_shape_on_card(dtype):
    """4,096,000 x 16 (block CG on laplace3d(160)), Kahan, against the
    compensated bound, and bulk-copied (the operands are aligned)."""
    need_card()
    V, W, X = _tsm_inputs(4_096_000, 16, 16, dtype, 16)
    rows, _ = row_partition(4_096_000, 16, 16)
    assert bulk_aligned(V, W, rows, stage_rows(16, 16, V.element_size()))
    got = tsmttsm(V, W, X, 0.5, -2.0, kahan=True)
    Vd, Wd, Xd = V.double(), W.double(), X.double()
    want = tsmttsm_ref(Vd, Wd, Xd, 0.5, -2.0)
    _within(got, want, 0.5 * (Vd.abs().T @ Wd.abs()) + 2.0 * Xd.abs(), dtype,
            KAHAN_TOL)
    assert torch.equal(got, tsmttsm(V, W, X, 0.5, -2.0, kahan=True))


@pytest.mark.gpu
@pytest.mark.parametrize("kahan", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,m,k", [(37, 3, 5), (4109, 1, 7), (70001, 5, 3),
                                   (70001, 7, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_tsmttsm_odd_widths_and_unaligned_views_on_card(dtype, n, m, k,
                                                        offset, kahan):
    """Odd m and k, and V and W as views one value into their buffers (off
    a 16-byte boundary): the stages are filled by plain loads where a bulk
    copy cannot take them, with the same sums."""
    need_card()
    g = torch.Generator(device="cuda").manual_seed(n + m + k)
    V, W = (torch.randn(n * w + offset, generator=g, device="cuda",
                        dtype=torch.float64).to(dtype)[offset:].view(n, w)
            for w in (m, k))
    rows, _ = row_partition(n, m, k)
    if offset:
        assert not bulk_aligned(V, W, rows, stage_rows(m, k, V.element_size()))
    got = tsmttsm(V, W, kahan=kahan)
    Vd, Wd = V.double(), W.double()
    _within(got, tsmttsm_ref(Vd, Wd), Vd.abs().T @ Wd.abs(), dtype,
            KAHAN_TOL if kahan else TSM_TOL)
    # the same values at an aligned address give the same bits
    assert torch.equal(got, tsmttsm(V.clone(), W.clone(), kahan=kahan))


@pytest.mark.gpu
def test_tsmttsm_kahan_beats_plain_sum_on_card():
    """float32 over 2^20 rows, pooled over four (m, k): the compensated
    kernel's rms error is at most half the plain sum's on the same inputs
    (a float32 emulation of the kernel's order gives about a quarter; a
    kernel that ignored ``kahan`` would give 1)."""
    need_card()
    errs = {False: [], True: []}
    for m, k in ((1, 1), (3, 8), (16, 16), (NARROW, NARROW)):
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


#: B3's template widths (square m = k), a generic width and others
TSMM_WIDTHS = [(w, w) for w in (1, 2, 4, 8, 16, 32, NARROW)] + [
    (5, 13), (3, 8), (8, 3), (16, 4), (1, NARROW), (NARROW, 1)]
TSMM_TOL = {**TSM_TOL, torch.complex128: 1e-13, torch.complex64: 1e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("with_w", ["none", "w", "alias"])
@pytest.mark.parametrize("m,k", TSMM_WIDTHS, ids=lambda w: str(w))
@pytest.mark.parametrize("n", [0, 1, 37, 4109, 70001])
@pytest.mark.parametrize("dtype", list(TSMM_TOL),
                         ids=lambda d: str(d).split(".")[-1])
def test_tsmm_matches_plain_on_card(dtype, n, m, k, with_w):
    """B3 on every template width (m = k = 1 ... 64), the generic
    instantiation (other m, k) and ragged n, without W, with W, and with
    W aliasing V (``tsmm_inplace``, m = k), against its plain version in
    float64 (complex128) within ``TSMM_TOL`` of alpha |V| |X| + |beta| |W|
    plus the output's rounding (relative, and at float16's subnormals
    absolute)."""
    need_card()
    if with_w == "alias" and m != k:
        pytest.skip("W aliases V only where m = k")
    wide = torch.complex128 if dtype.is_complex else torch.float64
    g = torch.Generator(device="cuda").manual_seed(n + 3 * m + k)
    V, W, X = (torch.randn(*shape, generator=g, device="cuda",
                           dtype=wide).to(dtype)
               for shape in ((n, m), (n, k), (m, k)))
    if with_w == "alias":
        W = V
    ab = (dict(alpha=1.5) if with_w == "none" else
          dict(alpha=0.5 - 0.25j, beta=-2.0 + 1j) if dtype.is_complex else
          dict(alpha=0.5, beta=-2.0))
    execution.reset_launch_counts()
    got = tsmm(V, X, None if with_w == "none" else W, **ab)
    assert execution.launch_counts().get("tsmm", 0) == (1 if n else 0)
    assert got.dtype == dtype and got.shape == (n, k)
    Vd, Wd, Xd = V.to(wide), W.to(wide), X.to(wide)
    want = tsmm_ref(Vd, Xd, None if with_w == "none" else Wd, **ab)
    scale = abs(ab["alpha"]) * (Vd.abs() @ Xd.abs())
    if with_w != "none":
        scale = scale + abs(ab["beta"]) * Wd.abs()
    fi = torch.finfo(dtype)
    lim = (TSMM_TOL[dtype] * scale + OUT_EPS.get(dtype, 0.0) * want.abs()
           + fi.tiny * fi.eps)      # a subnormal output's own rounding
    assert bool(((got.to(wide) - want).abs() <= lim).all())


@pytest.mark.gpu
@pytest.mark.parametrize("m,k", [(16, 16), (5, 13), (1, 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16, torch.complex64],
                         ids=lambda d: str(d).split(".")[-1])
def test_tsmm_unaligned_views_give_the_same_bits_on_card(dtype, m, k):
    """V and W as views one value past a 16-byte boundary take B3's
    value-by-value loads; each output sums in the same order, so the
    result equals the aligned copies' to the bit."""
    need_card()
    n = 4109
    g = torch.Generator(device="cuda").manual_seed(m + k)
    wide = torch.complex128 if dtype.is_complex else torch.float64
    V, W = (torch.randn(n * w + 1, generator=g, device="cuda",
                        dtype=wide).to(dtype)[1:].view(n, w)
            for w in (m, k))
    X = torch.randn(m, k, generator=g, device="cuda", dtype=wide).to(dtype)
    assert V.data_ptr() % 16 and W.data_ptr() % 16
    got = tsmm(V, X, W, 0.5, -2.0)
    assert torch.equal(got, tsmm(V.clone(), X, W.clone(), 0.5, -2.0))
    assert torch.equal(tsmm(V, X), tsmm(V.clone(), X))


def test_check_operand_refuses_a_conjugate_view():
    """``t.conj()`` of a contiguous complex tensor is contiguous and keeps
    the unconjugated values under a flag: a kernel reading its data would
    read the wrong values, so the wrappers' check refuses it."""
    from repro_torch.kernels.sellcs_spmv import check_operand
    t = torch.zeros(4, 2, dtype=torch.complex128)
    check_operand("f", "x", t, t.device, t.dtype, (4, 2))
    with pytest.raises(ValueError, match="conjugate view"):
        check_operand("f", "x", t.conj(), t.device, t.dtype, (4, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["sellcs_spmv", "tsmttsm", "tsmm", "tsmm_x",
                                "block_jacobi_apply", "fused_axpby_dots",
                                "herm_eig"])
def test_conjugate_views_give_their_values_on_card(op):
    """A conjugate view (contiguous, flagged) through each op on the card
    gives what its resolved copy gives: the ops resolve the flag before a
    kernel reads the data (B3's X once read unconjugated values, which
    stalled complex block CG once its (b, b) factors came row-major)."""
    need_card()
    from repro_torch.kernels.ops import (block_jacobi_apply,
                                         fused_axpby_dots, herm_eig)
    g = torch.Generator(device="cuda").manual_seed(26)

    def crandn(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.complex128)

    if op == "sellcs_spmv":
        A = _complex_matrix(np.complex128, n=64, C=8, sigma=1)
        x = crandn(A.nrows_pad, 4)
        run = lambda v: sellcs_spmv(A, v)[0]
    elif op == "tsmttsm":
        W = crandn(300, 5)
        x = crandn(300, 3)
        run = lambda v: tsmttsm(v, W)
    elif op == "tsmm":
        X = crandn(16, 16)
        x = crandn(300, 16)
        run = lambda v: tsmm(v, X, v, 0.5, -1.0)
    elif op == "tsmm_x":
        V = crandn(300, 16)
        x = crandn(16, 16)
        run = lambda v: tsmm(V, v)
    elif op == "block_jacobi_apply":
        blocks = crandn(10, 8, 8)
        x = crandn(80, 4)
        run = lambda v: block_jacobi_apply(blocks, v)
    elif op == "fused_axpby_dots":
        y = crandn(300, 4)
        x = crandn(300, 4)
        run = lambda v: torch.cat(fused_axpby_dots(v, y, 0.5 + 1j, -1.0,
                                                   dot_yy=True, dot_xy=True))
    else:
        Y = crandn(16, 16)
        x = Y @ Y.mH
        run = lambda v: herm_eig(v)[0]
    view = x.conj()
    assert view.is_conj() and view.is_contiguous()
    assert torch.equal(run(view), run(view.resolve_conj()))


@pytest.mark.gpu
def test_tsm_wrapper_refusals_on_card():
    need_card()
    V, W, X = _tsm_inputs(100, 4, 4, torch.float32, 0)
    with pytest.raises(TypeError, match="must be torch.float32"):
        tsmttsm_cuda(V, W.double())
    # a width past the old limit of 64 launches, held against the plain
    # version
    Vw, Ww = (torch.randn(1000, w, device="cuda") for w in (65, 2))
    got = tsmttsm_cuda(Vw, Ww)
    assert rel_err(got, tsmttsm_ref(Vw.double(), Ww.double())) <= 1e-5
    with pytest.raises(ValueError, match="contiguous"):
        tsmm_cuda(torch.zeros(4, 100, device="cuda").T, X)
    with pytest.raises(TypeError, match="no wider"):
        tsmm_cuda(V, X.double())
    # complex operands launch B2, held against the plain version
    Vc = torch.complex(V, torch.roll(V, 1, 0))
    Wc = torch.complex(W, torch.roll(W, 1, 0))
    execution.reset_launch_counts()
    got = tsmttsm(Vc, Wc)
    assert execution.launch_counts()["tsmttsm"] == 1
    assert complex_rel_err(got, tsmttsm_ref(Vc.to(torch.complex128),
                                            Wc.to(torch.complex128))) <= 1e-5
    with pytest.raises(ValueError, match="beta"):
        tsmm(V, X, None, 1.0, 2.0)


@pytest.mark.parametrize("m,k", [(1, 1), (3, 8), (5, 3), (16, 16),
                                 (1, 64), (64, 64)])
@pytest.mark.parametrize("n", [1, 37, 4109, 70001, 1 << 20, 4_096_000])
def test_tsmttsm_row_partition_covers_n(n, m, k):
    """Whole row-lane sweeps (lanes x 8-row groups) per block, at most
    MAX_BLOCKS blocks, together exactly the n rows."""
    rows, nblocks = row_partition(n, m, k)
    lanes = 256 // (-(-m // 4) * -(-k // 4))
    assert rows % (lanes * 8) == 0 and 1 <= nblocks <= MAX_BLOCKS
    assert (nblocks - 1) * rows < n <= nblocks * rows
    assert row_partition(0, m, k) == (0, 0)


def test_tsmttsm_row_partition_depends_on_the_shape_alone(monkeypatch):
    """The partition, and so the summation order, is a function of
    (n, m, k): it asks nothing of a card."""
    def no_card(*a, **kw):
        raise AssertionError("the partition asked the card")

    for name in ("get_device_properties", "device_count", "is_available"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert row_partition(4_096_000, 16, 16) == (7808, 525)
    assert row_partition(37, 3, 8) == (1024, 1)
    assert row_partition(4109, 64, 64) == (8, 514)
    assert row_partition(1 << 20, 1, 1) == (2048, 512)


def test_tsmttsm_summation_depth_by_hand():
    # 16 x 16: 16 lanes; a lane's 7808 / 16 = 488 rows, 16 lanes, then
    # 525 blocks in 31 runs of 17
    assert block_runs(525) == (17, 31)
    assert summation_depth(4_096_000, 16, 16) == 488 + 16 + 17 + 31
    # 3 x 8: 2 tiles a row, 128 lanes of 8 rows in one block (one run)
    assert summation_depth(37, 3, 8) == 8 + 128 + 1 + 1
    # 64 x 64: 256 tiles a row, one lane, 514 blocks of 8 rows
    assert block_runs(514) == (17, 31)
    assert summation_depth(4109, 64, 64) == 8 + 1 + 17 + 31
    assert summation_depth(1 << 20, 1, 1) == 8 + 256 + 16 + 32
    assert summation_depth(0, 16, 16) == 0 + 16 + 0
    # complex: 4 x 2 tiles, so 16 x 16 has 32 tiles a row and 8 lanes
    c128 = torch.complex128
    assert row_partition(4_096_000, 16, 16, c128) == (7808, 525)
    assert summation_depth(4_096_000, 16, 16, c128) == 976 + 8 + 17 + 31


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_tsmttsm_stage_rows(itemsize):
    assert stage_rows(16, 16, 8) == 128          # 32 KB: one group a lane
    assert stage_rows(16, 16, 4) == 256
    assert stage_rows(64, 64, 8) == 32
    assert stage_rows(1, 1, 8) == 2048
    assert stage_rows(3, 8, 8) == 256
    for m in range(1, NARROW + 1, 3):
        for k in range(1, NARROW + 1, 5):
            lanes = 256 // (-(-m // 4) * -(-k // 4))
            rows = stage_rows(m, k, itemsize)
            per_lane = rows // lanes
            assert rows % lanes == 0 and per_lane & (per_lane - 1) == 0
            assert 1 <= per_lane <= 64
            assert rows * (m + k) * itemsize <= STAGE_BYTES


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64],
                         ids=["complex128", "complex64"])
def test_tsmttsm_complex_tiles(dtype):
    """Complex values take 4 x 2 tiles: the lanes and the stages (16 KB
    for complex128) follow; past 256 tiles a row a block is one lane."""
    assert thread_tile(dtype) == (4, 2) and thread_tile() == (4, 4)
    limit = stage_bytes(dtype)
    assert limit == (STAGE_BYTES // 2 if dtype == torch.complex128
                     else STAGE_BYTES)
    item = torch.empty((), dtype=dtype).element_size()
    for m in range(1, NARROW + 1, 3):
        for k in range(1, NARROW + 1, 5):
            tiles = -(-m // 4) * -(-k // 2)
            lanes = max(1, 256 // tiles)
            rows = stage_rows(m, k, item, dtype)
            per_lane = rows // lanes
            assert rows % lanes == 0 and per_lane & (per_lane - 1) == 0
            # within the limit, or one row a lane where that is above it
            assert 1 <= per_lane <= 64
            assert rows * (m + k) * item <= limit or per_lane == 1
            for n in (1, 37, 4109, 4_096_000):
                r, nb = row_partition(n, m, k, dtype)
                assert r % (lanes * 8) == 0 and 1 <= nb <= MAX_BLOCKS
                assert (nb - 1) * r < n <= nb * r
    # 64 x 64: 512 tiles a row, one lane; 16 x 16: 32 tiles, 8 lanes
    assert row_partition(4109, NARROW, NARROW, dtype) == (8, 514)
    assert row_partition(4109, 16, 16, dtype) == (64, 65)


@pytest.mark.parametrize("nblocks", [0, 1, 31, 32, 33, 525, MAX_BLOCKS])
def test_tsmttsm_block_runs_cover_the_blocks(nblocks):
    """The finishing kernel's runs: at most 32 (a warp's lanes), each of
    ``run`` consecutive blocks but the last, together all the blocks."""
    run, runs = block_runs(nblocks)
    assert runs <= 32
    assert (runs - 1) * run < nblocks <= runs * run or nblocks == 0


def test_tsmttsm_bulk_aligned():
    V = torch.zeros(4096, 16, dtype=torch.float64)
    rows, _ = row_partition(4096, 16, 16)
    assert bulk_aligned(V, V, rows, stage_rows(16, 16, 8))
    U = torch.zeros(4096 * 3 + 1, dtype=torch.float32)[1:].view(4096, 3)
    rows, _ = row_partition(4096, 3, 3)
    assert not bulk_aligned(U, U, rows, stage_rows(3, 3, 4))
    # odd widths in a narrow type at an aligned base: whole sweeps of rows
    # keep the sizes multiples of 16 bytes
    B = torch.zeros(4096, 3, dtype=torch.bfloat16)
    assert bulk_aligned(B, B, rows, stage_rows(3, 3, 2))


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
    it = st.it + execution.discarded_counts().get("block_cg", 0)
    assert counts() == (it, 2 * it, 4 * it)
    res = cg(op, A.permute(b), tol=1e-8, maxiter=400, block=True)
    col = cg(op, A.permute(b), tol=1e-8, maxiter=400)
    assert bool(res.converged.all()) and res.iters <= col.iters
