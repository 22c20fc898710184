"""Tall-skinny^T x tall-skinny GEMM on Hopper: the wrapper of ``csrc/tsmttsm.cu``.

The CUDA port of ``repro/kernels/tsmttsm.py:tsmttsm_pallas`` (B2):
``X = alpha * V^T W + beta * X`` for real V ``(n, m)`` and W ``(n, k)``,
row-major, and ``alpha * V^H W + beta * X`` (or ``V^T W`` with
``conj=False``) for complex64/complex128 ones, with optional Kahan
compensation.  Blocks reduce row ranges
into ``(m, k)`` partials, streaming their rows through a ring of
shared-memory stages filled by bulk copies, and a second kernel sums the
partials in block order (see the note at the top of the CUDA source).
Float64 rows of more than 256 thread tiles (:func:`uses_dmma`) take the
FP64 tensor cores: a block a 128 x 64 (Kahan) or 128 x 128 result tile
of its row block, each row of V and W read once a tile; a self-Gram
(:func:`self_gram`) the 64 x 64 tiles on and above the diagonal.
This wrapper validates the operands, picks the row partition from the
shapes alone and the stage size from the shapes and the dtype, allocates
the partials and the result, and launches on the current stream without
synchronising.

It takes CUDA tensors only and raises on anything the kernel does not
take; the plain version is ``repro_torch.kernels.ref.tsmttsm_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import execution
from repro_torch.core.spmv import storage_acc_dtype
from repro_torch.kernels import _build
from repro_torch.kernels.sellcs_spmv import check_operand, coefficient_arg

__all__ = ["tsmttsm_cuda", "row_partition", "summation_depth",
           "stage_rows", "bulk_aligned", "thread_tile", "block_runs",
           "stage_bytes", "uses_dmma", "dmma_tiles", "self_gram",
           "column_blocks", "by_column_blocks", "STAGE_LIMIT", "DTYPE_CODES"]

#: the number of blocks the rows are spread over, at most (a constant, not
#: the card's SM count, so the summation order is the same on every card)
MAX_BLOCKS = 528
#: thread blocks of the partial kernel at most (row blocks x tile slabs)
#: where a row's tiles need more than four slabs (m * k above 16384 for
#: real values, 8192 for complex ones): the block partials' scratch then
#: stays near MAX_GRID * 256 tiles' values, whatever the widths
MAX_GRID = 4 * MAX_BLOCKS
#: shared memory one thread block may use on an H100
MAX_SMEM_BYTES = 232448
_THREADS, _GROUP = 256, 8
#: stages of the ring (``kStages`` of the CUDA source)
_STAGES = 3
#: complex128's Kahan compensation tile in shared memory (4 x 2 values of
#: 16 bytes a thread), kept free beside the ring for every dtype
_COMP_TILE_BYTES = 4 * 2 * _THREADS * 16
#: runs of block partials the finishing kernel sums apart (a warp's lanes)
_RUNS = 32
#: bytes of one shared-memory stage, at most (the ring has three; see
#: :func:`stage_bytes`)
STAGE_BYTES = 32768
#: the most rows of one lane a stage holds
_MAX_LANE_ROWS = 64

DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2,
               torch.float16: 3, torch.complex128: 4, torch.complex64: 5}

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_ARGTYPES = [_I, _I, _I, _P, _P, _P, _P, _L, _I, _I, _L, _I, _I, _I, _P, _P,
             _D, _D, _D, _D, _P, _P, _I, _I, _P]


def _entry():
    fn = _build.load("tsmttsm").tsmttsm_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def thread_tile(dtype: Optional[torch.dtype] = None):
    """``(rows of V, columns of W)`` of one thread's tile of the result
    (``csrc/tsmttsm.cu``'s ``Tile``): 4 x 4 for real values, 4 x 2 for
    complex ones."""
    return (4, 2) if dtype is not None and dtype.is_complex else (4, 4)


def stage_bytes(dtype: Optional[torch.dtype] = None) -> int:
    """Bytes of one shared-memory stage at most: :data:`STAGE_BYTES`, half
    that for complex128 (two blocks an SM, each with its ring and its
    compensation tile)."""
    return STAGE_BYTES // 2 if dtype == torch.complex128 else STAGE_BYTES


def _tiles(m: int, k: int, dtype) -> int:
    tm, tn = thread_tile(dtype)
    return -(-m // tm) * -(-k // tn)


def _lanes(m: int, k: int, dtype=None) -> int:
    """Row lanes of a block: 256 threads over the tiles of one row, or one
    lane where a row has more tiles than that (complex values at ``m * k
    > 2048``, real ones past 4096; the kernel then splits the tiles over
    grid.y, slabs of 256 each reading the whole rows)."""
    return max(1, _THREADS // _tiles(m, k, dtype))


def tile_slabs(m: int, k: int, dtype=None) -> int:
    """grid.y of the partial kernel: slabs of 256 of a row's tiles."""
    return -(-_tiles(m, k, dtype) // _THREADS)


#: the DMMA instance's result tile: rows (V's columns) by columns (W's) of
#: a thread block with Kahan (the plain sum's blocks are 128 x 128)
DMMA_TILE = (128, 64)


def self_gram(V: torch.Tensor, W: torch.Tensor) -> bool:
    """Whether ``V^T W`` is a self-Gram (``W^T W``: the same storage,
    shape and strides), whose DMMA instance computes the entries on and
    above the diagonal and mirrors the rest."""
    return (V.data_ptr() == W.data_ptr() and V.shape == W.shape
            and V.stride() == W.stride())


def uses_dmma(m: int, k: int, dtype=None) -> bool:
    """Whether the call takes the FP64 tensor cores (``tsmttsm_dmma``):
    float64 rows of more than 256 thread tiles (m * k past 4096 or so),
    which the other dtypes split into slabs.  ``dtype`` None means a real
    dtype other than float64."""
    return dtype == torch.float64 and _tiles(m, k, dtype) > _THREADS


def dmma_tiles(m: int, k: int) -> int:
    """Result tiles of :data:`DMMA_TILE` a row block has: the thread blocks
    of a row block with Kahan, which cap the row blocks (the plain sum's
    blocks are half as many or fewer, a self-Gram's 64 x 64 tiles on and
    above the diagonal about as many: 3 against 2 at 128 x 128)."""
    tm, tn = DMMA_TILE
    return -(-m // tm) * -(-k // tn)


def row_partition(n: int, m: int, k: int, dtype=None):
    """``(rows_per_block, nblocks)`` for ``n`` rows: at most
    :data:`MAX_BLOCKS` blocks (fewer where more than four tile slabs would
    put more than :data:`MAX_GRID` thread blocks in the grid), each a
    whole number of the block's row-lane sweeps (lanes x 8-row groups).
    The DMMA instance (:func:`uses_dmma`) has one lane and caps its row
    blocks by its result tiles (:func:`dmma_tiles`) as the slabs do.
    A function of ``(n, m, k)`` and of the thread tile of ``dtype`` (None:
    a real dtype other than float64) alone."""
    if n == 0:
        return 0, 0
    sweep = _lanes(m, k, dtype) * _GROUP
    tiles = (dmma_tiles(m, k) if uses_dmma(m, k, dtype)
             else tile_slabs(m, k, dtype))
    cap = max(1, min(MAX_BLOCKS, MAX_GRID // tiles))
    rows = -(-n // cap)
    rows = -(-rows // sweep) * sweep
    return rows, -(-n // rows)


def block_runs(nblocks: int):
    """``(run, runs)``: the finishing kernel sums the block partials in
    runs of ``run`` consecutive blocks, one run a lane of a warp, and then
    the ``runs`` runs in order."""
    if nblocks == 0:
        return 0, 0
    run = -(-nblocks // _RUNS)
    return run, -(-nblocks // run)


def summation_depth(n: int, m: int, k: int, dtype=None) -> int:
    """The longest chain of additions any product passes through in the
    kernel: its lane's rows of one block (a lane takes every L-th row of
    the block, in 8-row groups summed plainly and then added in order;
    the shared-memory stages do not change that order), then the lanes
    in lane order, then a run of blocks in block order, then the runs in
    run order (the ``depth`` of the standard bound ``depth * u * sum
    |terms|``).  The DMMA instance has no lanes: a block's rows pass
    through one chain of mma k-steps, each adding four rows' products to
    the running sum in the tensor core's own order, so a product passes
    at most the block's rows' additions (with Kahan, 8-row groups of two
    k-steps from zero, then added in order)."""
    rows, nblocks = row_partition(n, m, k, dtype)
    if uses_dmma(m, k, dtype):
        return rows + sum(block_runs(nblocks))
    lanes = _lanes(m, k, dtype)
    return -(-rows // lanes) + lanes + sum(block_runs(nblocks))


def stage_rows(m: int, k: int, itemsize: int, dtype=None) -> int:
    """Rows of V and W in one shared-memory stage: the row lanes times
    the largest power of two (at most 64) of rows per lane that keeps a
    stage within :func:`stage_bytes`.  It sets only how the rows are
    fetched, never the order in which they are summed."""
    lanes = _lanes(m, k, dtype)
    row_bytes = (m + k) * itemsize
    limit = stage_bytes(dtype)
    q = 1
    while q < _MAX_LANE_ROWS and 2 * q * lanes * row_bytes <= limit:
        q *= 2
    return lanes * q


def bulk_aligned(V: torch.Tensor, W: torch.Tensor, rows_per_block: int,
                 tile_rows: int) -> bool:
    """Whether the kernel may fill its stages with 16-byte bulk copies:
    V and W start on 16-byte boundaries, and a block's rows and a stage's
    rows of each are whole multiples of 16 bytes (the ragged last tile is
    checked in the kernel)."""
    sizes = (rows_per_block * V.shape[1] * V.element_size(),
             rows_per_block * W.shape[1] * W.element_size(),
             tile_rows * V.shape[1] * V.element_size(),
             tile_rows * W.shape[1] * W.element_size())
    return (V.data_ptr() % 16 == 0 and W.data_ptr() % 16 == 0
            and all(b % 16 == 0 for b in sizes))


def stage_smem(m: int, k: int, itemsize: int, dtype=None) -> int:
    """Bytes of the partial kernel's ring: three stages of
    :func:`stage_rows` rows of V and W, each 16-byte aligned."""
    rows = stage_rows(m, k, itemsize, dtype)
    r16 = lambda b: -(-b // 16) * 16
    return _STAGES * (r16(rows * m * itemsize) + r16(rows * k * itemsize))


def check_dims(fn: str, m: int, k: int) -> None:
    if m < 1 or k < 1:
        raise ValueError(f"{fn}: m={m}, k={k} must be at least 1")


#: the bytes the partial kernel's ring may take: a block's shared memory
#: less complex128's compensation tile
STAGE_LIMIT = MAX_SMEM_BYTES - _COMP_TILE_BYTES


def column_blocks(m: int, k: int, itemsize: int, dtype=None):
    """``(mb, kb)``: the widths of the column blocks ``V[:, I]`` and
    ``W[:, J]`` a call runs as, where three stages of one row of V and W
    exceed :data:`STAGE_LIMIT` (``(m, k)`` where they fit): the wider of the
    two halved until they fit.  The DMMA instance stages slices of its own
    and needs no split."""
    mb, kb = m, k
    while (not uses_dmma(m, k, dtype) and mb * kb > 1
           and stage_smem(mb, kb, itemsize, dtype) > STAGE_LIMIT):
        if mb >= kb:
            mb = -(-mb // 2)
        else:
            kb = -(-kb // 2)
    return mb, kb


def by_column_blocks(fn, V: torch.Tensor, W: torch.Tensor,
                     X: Optional[torch.Tensor], alpha, beta, mb: int,
                     kb: int) -> torch.Tensor:
    """``alpha V^H W + beta X`` as its blocks ``out[I, J] = fn(V[:, I],
    W[:, J], X[I, J], alpha, beta)`` for column blocks of ``mb`` and ``kb``
    (each block of V and W copied once into a contiguous tensor); ``fn``
    computes one block as the whole call would (the same rows in the same
    order, so each entry's sum over the rows does not change)."""
    m, k = int(V.shape[1]), int(W.shape[1])
    out = torch.empty((m, k), dtype=torch.promote_types(V.dtype, W.dtype),
                      device=V.device)
    Ws = [W[:, j:j + kb].contiguous() for j in range(0, k, kb)]
    for i in range(0, m, mb):
        Vi = V[:, i:i + mb].contiguous()
        for j, Wj in zip(range(0, k, kb), Ws):
            Xij = None if X is None else X[i:i + mb, j:j + kb]
            out[i:i + mb, j:j + kb] = fn(Vi, Wj, Xij, alpha, beta)
    return out


def tsmttsm_cuda(V: torch.Tensor, W: torch.Tensor,
                 X: Optional[torch.Tensor] = None, alpha=1.0, beta=0.0, *,
                 kahan: bool = False, conj: bool = True) -> torch.Tensor:
    """Run the tsmttsm kernel on the card: ``alpha * V^T W + beta * X``
    (``V^H W`` for complex V with ``conj``).

    V ``(n, m)`` and W ``(n, k)`` share one dtype; the result is ``(m, k)``
    in that dtype, summed in the accumulation dtype (float32 for
    bfloat16/float16).  ``X`` (a real dtype, or a complex one for complex
    V) is read in the accumulation dtype.  ``alpha``/``beta`` are numbers
    or 0-d tensors (one on the card is read there, never on the host),
    complex ones for complex V only.  Any m and k: where three stages of
    one row of V and W do not fit in shared memory (:func:`column_blocks`)
    the call runs as column blocks (:func:`by_column_blocks`), each
    through the kernel with the whole call's row partition, so that each
    entry's sum and its Kahan compensation are the ones a single launch
    would form.
    """
    fn = "tsmttsm"
    device = V.device
    if device.type != "cuda":
        raise ValueError(f"tsmttsm_cuda takes CUDA tensors, V is on {device}")
    if V.dtype not in DTYPE_CODES:
        raise TypeError(f"{fn}: no kernel for {V.dtype}")
    if V.ndim != 2 or W.ndim != 2 or V.shape[0] != W.shape[0]:
        raise ValueError(f"{fn}: V (n, m) and W (n, k) must share n, got "
                         f"{tuple(V.shape)} and {tuple(W.shape)}")
    n, m = (int(s) for s in V.shape)
    k = int(W.shape[1])
    check_dims(fn, m, k)
    check_operand(fn, "V", V, device, V.dtype, (n, m))
    check_operand(fn, "W", W, device, V.dtype, (n, k))
    if X is not None:
        if X.device != device or tuple(X.shape) != (m, k):
            raise ValueError(f"{fn}: X must be ({m}, {k}) on {device}, got "
                             f"{tuple(X.shape)} on {X.device}")
        if X.is_complex() and not V.is_complex():
            raise TypeError(f"{fn}: X must be real for real V, got {X.dtype}")
    mb, kb = column_blocks(m, k, V.element_size(), V.dtype)
    partition = row_partition(n, m, k, V.dtype)
    if (mb, kb) == (m, k):
        return _launch(V, W, X, alpha, beta, kahan, conj, partition)
    # the whole call's rows, where a block's row lanes are the call's
    lanes = _lanes(m, k, V.dtype)
    return by_column_blocks(
        lambda Vi, Wj, Xij, a, b: _launch(
            Vi, Wj, Xij, a, b, kahan, conj,
            partition if _lanes(Vi.shape[1], Wj.shape[1], V.dtype) == lanes
            else row_partition(n, Vi.shape[1], Wj.shape[1], V.dtype)),
        V, W, X, alpha, beta, mb, kb)


def _launch(V, W, X, alpha, beta, kahan, conj, partition) -> torch.Tensor:
    """One launch of the partial and finishing kernels on checked operands
    whose stages fit, over the row partition ``(rows, nblocks)``."""
    fn = "tsmttsm"
    device = V.device
    n, m = (int(s) for s in V.shape)
    k = int(W.shape[1])
    dmma = uses_dmma(m, k, V.dtype)
    acc = storage_acc_dtype(V.dtype)
    x_in = None if X is None else X.resolve_conj().to(acc).contiguous()
    rows, nblocks = partition
    # the DMMA instance ignores both: it fills its stages by bulk copies
    # where V and W start on 16 bytes and m and k are even, else by cp.async
    tile_rows = stage_rows(m, k, V.element_size(), V.dtype)
    bulk = not dmma and bulk_aligned(V, W, rows, tile_rows)
    part = torch.empty((nblocks, m, k), dtype=acc, device=device)
    comp = torch.empty_like(part) if kahan else None
    out = torch.empty((m, k), dtype=V.dtype, device=device)
    ca, cb = (coefficient_arg(fn, name, v, acc, device)
              for name, v in (("alpha", alpha), ("beta", beta)))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _entry()(
            DTYPE_CODES[V.dtype], int(kahan), int(conj and V.is_complex()),
            V.data_ptr(), W.data_ptr(),
            part.data_ptr(), None if comp is None else comp.data_ptr(),
            n, m, k, rows, nblocks, tile_rows, int(bulk),
            None if x_in is None else x_in.data_ptr(), out.data_ptr(),
            ca.re, cb.re, ca.im, cb.im, ca.ptr, cb.ptr,
            int(x_in is not None), int(dmma and self_gram(V, W)), stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    execution.count_launch("tsmttsm")
    return out
