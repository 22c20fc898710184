"""Parity of the port with the JAX package past the port's old size limits,
on the CPU: B2 (tsmttsm) and B3 (tsmm) past width 64, block-Jacobi at
bs = 128, the scan at N = 128, SELL-C-sigma at C = 512 and C = nrows
(ELLPACK), and block CG at width 72; and the launch plans of the wide
instances, which are Python.

The port's side is its plain version (``kernels/ref.py``, what a wrapper
runs on the CPU); the JAX side runs its Pallas kernels in interpret mode
as the JAX package's own tests run them (complex values, which the
interpreter does not take, through the JAX wrapper's plain reference).
Inputs are made with numpy from a seed and handed to both.  Tolerances:
float64 results to 1e-12 of the largest entry (the two sum in other
orders), float32 (the scan) to 1e-5; SELL-C-sigma's arrays bit for bit;
block CG's iteration count exactly (float64, the JAX side under x64).
The card instances themselves are held against the plain versions by
``tests/test_torch_wide_card.py`` and ``chip_smoke.py``'s wide grids
(rehearsed on the CPU by ``tests/test_torch_wide_rehearsal.py``).
"""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core.spmv import SpmvOpts as JSpmvOpts  # noqa: E402
from repro.core.spmv import spmv_ref as jspmv_ref  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.block_diag import block_diag_matmul_pallas  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan_pallas  # noqa: E402
from repro.kernels.tsmm import tsmm_pallas  # noqa: E402
from repro.kernels.tsmttsm import tsmttsm_pallas  # noqa: E402
from repro.solvers import make_operator as jmake_operator  # noqa: E402
from repro_torch.core import SpmvOpts, from_coo  # noqa: E402
from repro_torch.interop import SELLCS_ARRAYS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tsmttsm as b2  # noqa: E402
from repro_torch.kernels.sellcs_spmv import (chunk_parts, dot_parts,  # noqa: E402
                                             launch_geometry)
from repro_torch.matrices import laplace3d  # noqa: E402
from repro_torch.solvers import cg, make_operator  # noqa: E402

jcg = importlib.import_module("repro.solvers.cg")


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dtype,kahan", [(np.float64, True),
                                         (np.complex128, False),
                                         (np.complex128, True)],
                         ids=["float64-kahan", "complex128",
                              "complex128-kahan"])
def test_tsmttsm_past_64_matches_jax(dtype, kahan):
    rng = np.random.default_rng(96)
    V, W, X = (rng.standard_normal(s) for s in ((256, 96), (256, 80),
                                               (96, 80)))
    if dtype == np.complex128:
        V, W, X = (a + 1j * rng.standard_normal(a.shape) for a in (V, W, X))
    alpha, beta = (0.5 - 0.5j, 2.0j) if dtype == np.complex128 else (0.5,
                                                                     -2.0)
    with jax.enable_x64(True):
        args = (jnp.asarray(V), jnp.asarray(W), jnp.asarray(X), alpha, beta)
        if dtype == np.complex128:   # the interpreter takes no complex128
            want = jops.tsmttsm(*args, kahan=kahan)
        else:
            want = tsmttsm_pallas(*args, row_tile=128, kahan=kahan,
                                  interpret=True)
        want = np.asarray(want)
    got = ops.tsmttsm(*(torch.from_numpy(a) for a in (V, W, X)), alpha, beta,
                      kahan=kahan)
    _close(got.numpy(), want, 1e-12)


def test_tsmm_past_64_matches_jax():
    rng = np.random.default_rng(130)
    V, X, W = (rng.standard_normal(s) for s in ((256, 96), (96, 130),
                                               (256, 130)))
    with jax.enable_x64(True):
        want = np.asarray(tsmm_pallas(jnp.asarray(V), jnp.asarray(X),
                                      jnp.asarray(W), 1.5, 0.5, row_tile=128,
                                      interpret=True))
    got = ops.tsmm(*(torch.from_numpy(a) for a in (V, X, W)), 1.5, 0.5)
    _close(got.numpy(), want, 1e-12)


def test_block_jacobi_apply_at_bs_128_matches_jax():
    rng = np.random.default_rng(128)
    blocks = rng.standard_normal((3, 128, 128))
    x = rng.standard_normal((384, 4))
    with jax.enable_x64(True):
        want = np.asarray(block_diag_matmul_pallas(
            jnp.asarray(blocks), jnp.asarray(x), row_tile=128,
            interpret=True))
    got = ops.block_jacobi_apply(torch.from_numpy(blocks), torch.from_numpy(x))
    _close(got.numpy(), want, 1e-12)


def test_scan_at_n_128_matches_jax():
    rng = np.random.default_rng(64)
    f = np.float32
    dt = np.log1p(np.exp(rng.standard_normal((1, 64, 16)) - 2.0)).astype(f)
    xc = rng.standard_normal((1, 64, 16)).astype(f)
    Bc, Cc = (rng.standard_normal((1, 64, 128)).astype(f) for _ in range(2))
    A = (-np.exp(0.5 * rng.standard_normal((16, 128)))).astype(f)
    args = (dt, xc, Bc, Cc, A)
    want = np.asarray(mamba_scan_pallas(*(jnp.asarray(a) for a in args),
                                        d_tile=16, s_blk=64, interpret=True))
    got = ops.mamba_scan(*(torch.from_numpy(a) for a in args))
    _close(got.numpy(), want, 1e-5)


def _tall_problem(n=700, seed=5):
    rng = np.random.default_rng(seed)
    rowlen = rng.integers(0, 9, n)
    rows = np.repeat(np.arange(n), rowlen)
    cols = rng.integers(0, n, rows.size)
    return rows, cols, rng.standard_normal(rows.size), (n, n)


@pytest.mark.parametrize("C", [512, 700], ids=["512", "nrows"])
def test_tall_chunks_build_and_multiply_as_jax(C):
    """from_coo at C = 512 and at C = nrows (ELLPACK, sigma 1): the arrays
    equal the JAX build's bit for bit, and the SpMMV with dots agrees with
    the JAX package's ``spmv_ref``."""
    rows, cols, vals, shape = _tall_problem()
    with jax.enable_x64(True):
        Aj = jfrom_coo(rows, cols, vals, shape, C=C, sigma=1,
                       dtype=np.float64)
        At = from_coo(rows, cols, vals, shape, C=C, sigma=1,
                      dtype=np.float64, device="cpu")
        for f in SELLCS_ARRAYS:
            np.testing.assert_array_equal(np.asarray(getattr(At, f)),
                                          np.asarray(getattr(Aj, f)),
                                          err_msg=f)
        assert At.C == C and At.nchunks == Aj.nchunks
        x = np.random.default_rng(1).standard_normal((At.nrows_pad, 3))
        kw = dict(alpha=0.5, dot_yy=True, dot_xy=True, dot_xx=True)
        jy, _, jd = jspmv_ref(Aj, jnp.asarray(x), opts=JSpmvOpts(**kw))
        jy, jd = np.asarray(jy), np.asarray(jd)
    y, _, d = ops.sellcs_spmv(At, torch.from_numpy(x), opts=SpmvOpts(**kw))
    _close(y.numpy(), jy, 1e-12)
    _close(d.numpy(), jd, 1e-12)


def test_block_cg_at_width_72_matches_jax():
    """cg(block=True) past the old width of 64 (the CPU runs the plain
    versions and torch.linalg.eigh) takes the JAX package's iterations."""
    r, c, v, n = laplace3d(8)
    b = np.random.default_rng(72).standard_normal((n, 72))
    with jax.enable_x64(True):
        Aj = jfrom_coo(r, c, v, (n, n), C=32, sigma=64, dtype=np.float64)
        jres = jcg.cg(jmake_operator(Aj, impl="ref"), Aj.permute(b),
                      tol=1e-8, maxiter=200, block=True)
        j_iters = int(jres.iters)
        j_x = np.asarray(Aj.unpermute(jres.x))
    A = from_coo(r, c, v, (n, n), C=32, sigma=64, dtype=np.float64,
                 device="cpu")
    res = cg(make_operator(A), A.permute(torch.from_numpy(b)), tol=1e-8,
             maxiter=200, block=True)
    assert bool(res.converged.all())
    assert res.iters == j_iters
    _close(A.unpermute(res.x).numpy(), j_x, 1e-6)


# --------------------------------------------- the wide launch plans (Python)
def test_launch_geometry_spreads_tall_chunks_over_blocks():
    """A chunk whose rows need more than 512 threads spreads over blocks of
    512 (chunk_parts); up to 512 a chunk keeps one block; the dot
    partials follow the block count."""
    f64, c128 = torch.float64, torch.complex128
    for b, C, dt, parts in ((4, 32, f64, 1), (16, 32, f64, 1),
                            (4, 1024, f64, 4), (16, 256, f64, 4),
                            (4, 4_096_000, f64, 16000), (1, 512, f64, 1),
                            (1, 513, f64, 2), (16, 4096, c128, 64)):
        g = launch_geometry(b, C, dt)
        assert chunk_parts(C, g) == parts
        rows = g.threads // g.tpr
        assert (parts - 1) * rows < C <= parts * rows
    assert dot_parts(1, 16000) == 16000
    assert dot_parts(9, 4) == 3 * 4
    assert dot_parts(128000) == dot_parts(128000, 1) == 32000


@pytest.mark.parametrize("m,k,dtype", [(65, 65, None), (96, 96, None),
                                       (128, 128, None), (100, 72, None),
                                       (128, 128, torch.complex128),
                                       (4100, 4200, None)])
def test_tsmttsm_wide_partition_caps_the_grid(m, k, dtype):
    """Past four slabs of 256 tiles the rows spread over fewer blocks, so
    the grid holds at most MAX_GRID blocks and the partials' scratch stays
    bounded; up to four slabs the partition is the narrow one's."""
    n = 4_096_000
    rows, nblocks = b2.row_partition(n, m, k, dtype)
    slabs = b2.tile_slabs(m, k, dtype)
    assert (nblocks - 1) * rows < n <= nblocks * rows
    assert nblocks * slabs <= max(b2.MAX_GRID, slabs)
    if slabs <= 4:
        assert nblocks <= b2.MAX_BLOCKS and nblocks >= b2.MAX_BLOCKS - 8
    itemsize = 16 if dtype == torch.complex128 else 8
    assert (b2.stage_smem(m, k, itemsize, dtype)
            <= b2.MAX_SMEM_BYTES - b2._COMP_TILE_BYTES)
    # 128 x 128 in float64: 528 blocks of 4 slabs, 69 MB of partials
    if (m, k, dtype) == (128, 128, None):
        assert (nblocks, slabs) == (528, 4)
        assert nblocks * m * k * 8 == 69_206_016


def test_tsmttsm_refuses_only_rows_wider_than_shared_memory():
    """The one width B2 cannot take: three stages of one row of V and W
    beyond a block's shared memory (m + k past 8,320 at 8 bytes a value,
    complex64; float64 takes the DMMA instance at any width)."""
    limit = b2.MAX_SMEM_BYTES - b2._COMP_TILE_BYTES
    assert b2.stage_smem(4100, 4200, 8) <= limit
    assert b2.stage_smem(4200, 4200, 8) > limit


# ------------------------- B2's float64 instance on DMMA (Python, PR 30)
@pytest.mark.parametrize("m,k,dtype,want", [
    (64, 64, torch.float64, False), (65, 64, torch.float64, True),
    (61, 67, torch.float64, True), (60, 67, torch.float64, False),
    (128, 128, torch.float64, True), (200, 136, torch.float64, True),
    (128, 1, torch.float64, False), (3, 4100, torch.float64, True),
    (128, 128, torch.float32, False), (128, 128, torch.complex128, False),
    (128, 128, None, False)])
def test_tsmttsm_dmma_takes_the_float64_slab_shapes(m, k, dtype, want):
    """Float64 rows of more than 256 thread tiles of 4 x 4 (the shapes the
    slab path took) take the FP64 tensor cores; every other dtype, and
    every narrower row, keeps its design."""
    assert b2.uses_dmma(m, k, dtype) == want
    tiles = -(-m // 4) * -(-k // 4)
    assert want == (dtype == torch.float64 and tiles > 256)


@pytest.mark.parametrize("n", [0, 1, 37, 4109, 1 << 18, 4_096_000])
@pytest.mark.parametrize("m,k", [(65, 65), (72, 100), (128, 128),
                                 (200, 136), (4100, 4200)])
def test_tsmttsm_dmma_partition_and_depth(m, k, n):
    """The DMMA instance's row blocks: whole 8-row groups, at most
    MAX_BLOCKS, and at most MAX_GRID thread blocks with Kahan (one a
    128 x 64 result tile and row block); its summation depth is a row
    block's rows (one chain of mma k-steps) plus the finishing kernel's
    run and runs, with no lane term."""
    f64 = torch.float64
    rows, nblocks = b2.row_partition(n, m, k, f64)
    if n == 0:
        assert (rows, nblocks) == (0, 0)
        assert b2.summation_depth(n, m, k, f64) == 0
        return
    tiles = b2.dmma_tiles(m, k)
    assert tiles == -(-m // 128) * -(-k // 64)
    assert rows % 8 == 0 and (nblocks - 1) * rows < n <= nblocks * rows
    assert nblocks <= b2.MAX_BLOCKS
    assert nblocks * tiles <= max(b2.MAX_GRID, tiles)
    assert b2.summation_depth(n, m, k, f64) == rows + sum(
        b2.block_runs(nblocks))
    if (n, m, k) == (4_096_000, 128, 128):
        assert (rows, nblocks) == (7760, 528)
        assert b2.summation_depth(n, m, k, f64) == 7760 + 17 + 32


def test_tsmttsm_dmma_lifts_the_float64_width_limit():
    """Float64 takes any width (the DMMA stages hold 16 rows of 128 + 64
    columns whatever m and k are); the refusal of rows wider than three
    shared-memory stages stays with the slab path's dtypes."""
    limit = b2.MAX_SMEM_BYTES - b2._COMP_TILE_BYTES
    assert b2.uses_dmma(4200, 4200, torch.float64)
    assert b2.stage_smem(4200, 4200, 8, torch.float64) > limit
    assert b2.stage_smem(8400, 8400, 4, torch.float32) > limit
    assert not b2.uses_dmma(8400, 8400, torch.float32)


def test_tsmttsm_self_gram_is_the_same_storage():
    """The self-Gram path (V is W: same storage, shape and strides) is told
    apart from a copy and from views of other columns."""
    W = torch.randn(50, 8, dtype=torch.float64)
    assert b2.self_gram(W, W)
    assert b2.self_gram(W[:, :5], W[:, :5])
    assert not b2.self_gram(W, W.clone())
    assert not b2.self_gram(W[:, :5], W[:, 1:6])
    assert not b2.self_gram(W[:, :4], W[:, :5])
