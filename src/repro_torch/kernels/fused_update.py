"""Fused AXPBY + column dots on Hopper: the wrapper of ``csrc/fused_update.cu``.

The CUDA port of ``repro/kernels/fused_update.py:fused_axpby_dots_pallas``
(B5): ``y' = a x + b y`` for ``(n, bw)`` blocks of vectors, with ``a`` and
``b`` scalars or one value per column, and optionally the per-column dots
``<y', y'>``, ``<x, y'>`` and ``<x, x>`` in the same sweep.  Thread blocks
reduce their tiles of entries into ``(3, bw)`` partials and a second
kernel sums them in a fixed order (see the note at the top of the CUDA
source).  This wrapper validates the operands, picks the number of thread
blocks from ``n`` and ``bw`` alone, hands the coefficients over in the
accumulation dtype, allocates the outputs and launches on the current
stream without synchronising.

It takes CUDA tensors only and raises on anything the kernel does not
take; the plain version is ``repro_torch.kernels.ref.fused_axpby_dots_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import execution
from repro_torch.core.spmv import storage_acc_dtype
from repro_torch.kernels import _build
from repro_torch.kernels.sellcs_spmv import check_operand
from repro_torch.kernels.tsmttsm import DTYPE_CODES

__all__ = ["fused_axpby_dots_cuda", "MAX_BW", "partition",
           "summation_depth", "coefficients"]

#: widest block vector the kernel takes (one thread block of 256 threads
#: holds at least one lane of every column)
MAX_BW = 256
#: the number of thread blocks the tiles are spread over, at most (a
#: constant, not the card's SM count, so the summation order is the same on
#: every card)
MAX_BLOCKS = 528
_THREADS, _IN_FLIGHT, _WARP = 256, 8, 32
_DOT_YY, _DOT_XY, _DOT_XX = 1, 2, 4

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I] + [_P] * 7 + [_L, _I, _I, _I, _P]


def _entry():
    fn = _build.load("fused_update").fused_update_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def partition(n: int, bw: int):
    """``(ntiles, nblocks)`` for ``n`` rows of ``bw`` entries: tiles of
    8 entries per thread of a 256-thread block, spread over at most
    :data:`MAX_BLOCKS` thread blocks."""
    tile = _IN_FLIGHT * (_THREADS // bw) * bw
    ntiles = -(-n * bw // tile)
    return ntiles, min(MAX_BLOCKS, ntiles)


def summation_depth(n: int, bw: int) -> int:
    """The longest chain of additions any dot term passes through in the
    kernel: its thread's entries (8 per tile), then the block's lanes, then
    a finishing lane's blocks and the five butterfly steps (the ``depth``
    of the bound ``depth * u * sum |terms|``)."""
    ntiles, nblocks = partition(n, bw)
    if nblocks == 0:
        return 0
    per_thread = _IN_FLIGHT * -(-ntiles // nblocks)
    return per_thread + _THREADS // bw + -(-nblocks // _WARP) + 5


def coefficients(c, bw: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A coefficient (a number, a 0-d tensor or ``(bw,)``) as ``(bw,)`` in
    ``dtype``, as the JAX kernel broadcasts it."""
    return torch.as_tensor(c, dtype=dtype, device=device).broadcast_to(
        (bw,)).contiguous()


def fused_axpby_dots_cuda(x: torch.Tensor, y: torch.Tensor, a=1.0, b=1.0, *,
                          dot_yy: bool = False, dot_xy: bool = False,
                          dot_xx: bool = False):
    """Run the fused AXPBY + dots kernel on the card.

    ``x`` and ``y`` are ``(n, bw)`` with real dtypes that may differ; ``y'``
    is ``(n, bw)`` in ``promote_types(x, y)`` and the dots ``(3, bw)``
    (rows yy, xy, xx; zeros where not asked) in its accumulation dtype
    (float32 for bfloat16/float16), or None when no dot is asked.
    Returns ``(y', dots)``.
    """
    fn = "fused_axpby_dots"
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"fused_axpby_dots_cuda takes CUDA tensors, x is on "
                         f"{device}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{fn}: no kernel for {name} of {t.dtype}")
    if x.ndim != 2 or tuple(y.shape) != tuple(x.shape):
        raise ValueError(f"{fn}: y{tuple(y.shape)} must match x"
                         f"{tuple(x.shape)}, both (n, bw)")
    n, bw = (int(s) for s in x.shape)
    if not 1 <= bw <= MAX_BW:
        raise ValueError(f"{fn}: bw={bw} outside 1..{MAX_BW}")
    check_operand(fn, "x", x, device, x.dtype, (n, bw))
    check_operand(fn, "y", y, device, y.dtype, (n, bw))
    out_dtype = torch.promote_types(x.dtype, y.dtype)
    acc = storage_acc_dtype(out_dtype)
    av = coefficients(a, bw, acc, device)
    bv = coefficients(b, bw, acc, device)
    flags = ((_DOT_YY if dot_yy else 0) | (_DOT_XY if dot_xy else 0)
             | (_DOT_XX if dot_xx else 0))
    _, nblocks = partition(n, bw)
    out = torch.empty((n, bw), dtype=out_dtype, device=device)
    part = dots = None
    if flags:
        part = torch.empty((nblocks, 3, bw), dtype=acc, device=device)
        dots = torch.empty((3, bw), dtype=acc, device=device)
    if nblocks == 0 and not flags:
        return out, None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _entry()(
            DTYPE_CODES[x.dtype], DTYPE_CODES[y.dtype], x.data_ptr(),
            y.data_ptr(), av.data_ptr(), bv.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if dots is None else dots.data_ptr(),
            n, bw, nblocks, flags, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    execution.count_launch(fn)
    return out, dots
