"""Fused AXPBY + column dots on Hopper: the wrapper of ``csrc/fused_update.cu``.

The CUDA port of ``repro/kernels/fused_update.py:fused_axpby_dots_pallas``
(B5): ``y' = a x + b y`` for ``(n, bw)`` blocks of vectors, any
``bw >= 1``, with ``a`` and ``b`` scalars or one value per column, and
optionally the per-column dots ``<y', y'>``, ``<x, y'>`` and ``<x, x>`` in
the same sweep and the same launch, for real and for complex64/complex128
operands (complex dots are conjugate-linear in their first argument and
summed in complex128 on the card).  Threads move 16-byte vectors of a
fixed set of columns (:func:`partition`), and the last blocks to finish
sum the blocks' partials in a fixed order (see the note at the top of the
CUDA source).  This wrapper validates the operands, picks the partition
from ``n``, ``bw`` and the dtype alone, hands the coefficients over by
value or, for tensors on the card, by pointer
(:func:`~repro_torch.kernels.sellcs_spmv.coefficient_arg`: no host sync),
allocates the outputs and the partials, keeps the finish's counters (left
at zero by every launch) a stream, and launches on the current stream
without synchronising.

It takes CUDA tensors only and raises on anything the kernel does not
take; the plain version is ``repro_torch.kernels.ref.fused_axpby_dots_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core import execution
from repro_torch.core.spmv import storage_acc_dtype
from repro_torch.kernels import _build
from repro_torch.kernels.sellcs_spmv import check_operand, coefficient_arg
from repro_torch.kernels.tsmttsm import DTYPE_CODES

__all__ = ["fused_axpby_dots_cuda", "Partition", "partition",
           "summation_depth", "coefficients"]

#: threads of a block; blocks whose partials one block sums (the CUDA
#: source's kThreads and kGroup)
THREADS, GROUP, WARP = 256, 32, 32
#: the H100's SMs and the blocks an SM the kernel's launch bounds keep
#: room for: the blocks along x are at most their product, one wave there
#: (constants, not the card's SM count, so the summation order is the same
#: on every card)
SMS, BLOCKS_PER_SM = 132, 2
#: counters a stream's workspace holds (at most ceil(SMS * BLOCKS_PER_SM
#: / GROUP) + 1 are used)
_COUNTERS = 64
_DOT_YY, _DOT_XY, _DOT_XX = 1, 2, 4

_P, _I, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
_ARGTYPES = ([_I, _I, _P, _P] + [_P, _I, _D, _D] * 2 + [_P] * 5
             + [_L, _I, _I, _I, _I, _I, _P])

#: zeroed counters of the finish, by (card, stream)
_counters: Dict[Tuple[int, int], torch.Tensor] = {}
_launch = []


def _entry():
    if not _launch:
        fn = _build.load("fused_update").fused_update_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _launch.append(fn)
    return _launch[0]


class Partition(NamedTuple):
    vec: int         # V: entries of a 16-byte vector of the output dtype
    period: int      # P = lcm(bw, V) entries (whole rows)
    slots: int       # Q = P / V vectors of a period
    slot_tiles: int  # grid.y: slot tiles of at most THREADS slots
    slot_tile: int   # slots of one slot tile
    lanes: int       # periods a block holds side by side
    unroll: int      # periods' vectors a thread loads before using any
    ntiles: int      # tiles of unroll * lanes periods
    nbx: int         # blocks along grid.x (1 at least)
    ngroups: int     # groups of GROUP blocks the finish sums


@functools.lru_cache(maxsize=256)
def partition(n: int, bw: int, dtype: torch.dtype) -> Partition:
    """How the kernel cuts ``n`` rows of ``bw`` entries of output
    ``dtype`` (``promote_types(x, y)``): vectors of ``V = 16 / itemsize``
    entries, periods of ``lcm(bw, V)`` entries, whose ``Q`` vectors go to
    ``Q`` threads of fixed columns (``lanes`` periods a block; past 256
    slots, slot tiles along grid.y), tiles of ``unroll * lanes`` periods
    walked by ``nbx`` blocks, at most ``SMS * BLOCKS_PER_SM`` over the
    slot tiles."""
    V = 16 // dtype.itemsize
    P = bw // math.gcd(bw, V) * V
    Q = P // V
    nst = -(-Q // THREADS)
    Qt = -(-Q // nst)
    lanes = THREADS // Qt
    unroll = 2 if V == 8 else 4
    periods = -(-n * bw // P)
    ntiles = -(-periods // (unroll * lanes))
    max_bx = -(-SMS * BLOCKS_PER_SM // nst)
    nbx = max(1, min(ntiles, max_bx))
    return Partition(V, P, Q, nst, Qt, lanes, unroll, ntiles, nbx,
                     -(-nbx // GROUP))


def summation_depth(n: int, bw: int, dtype: torch.dtype) -> int:
    """The longest chain of additions any dot term passes through in the
    kernel: its thread's entries (``unroll`` a tile), then the block's
    lanes (where a slot tile divides a warp, a butterfly over the warp's
    lanes and the block's warps in order; else the lanes in order), then
    its group's blocks, then the groups' sums of each of a column's
    ``period / bw`` offsets (the ``depth`` of the bound ``depth * u * sum
    |terms|``)."""
    if n * bw == 0:
        return 0
    p = partition(n, bw, dtype)
    if WARP % p.slot_tile == 0:
        lanes = (WARP // p.slot_tile).bit_length() - 1 + THREADS // WARP
    else:
        lanes = p.lanes
    return (p.unroll * -(-p.ntiles // p.nbx) + lanes + min(GROUP, p.nbx)
            + p.ngroups * (p.period // bw))


def coefficients(c, bw: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A coefficient (a number, a 0-d tensor or ``(bw,)``) as the ``(bw,)``
    values in ``dtype`` that the kernel applies, as the JAX kernel
    broadcasts it (for checks: a number is uploaded here)."""
    arg = coefficient_arg("fused_axpby_dots", "coefficient", c, dtype,
                          device, bw)
    if arg.values is not None:
        return arg.values.broadcast_to((bw,)).contiguous()
    v = complex(arg.re, arg.im) if dtype.is_complex else arg.re
    return torch.full((bw,), v, dtype=dtype, device=device)


def _counter_workspace(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    ws = _counters.get(key)
    if ws is None:
        ws = _counters[key] = torch.zeros(_COUNTERS, dtype=torch.int32,
                                          device=device)
    return ws


def fused_axpby_dots_cuda(x: torch.Tensor, y: torch.Tensor, a=1.0, b=1.0, *,
                          dot_yy: bool = False, dot_xy: bool = False,
                          dot_xx: bool = False):
    """Run the fused AXPBY + dots kernel on the card.

    ``x`` and ``y`` are ``(n, bw)`` with dtypes that may differ; ``y'``
    is ``(n, bw)`` in ``promote_types(x, y)`` and the dots ``(3, bw)``
    (rows yy, xy, xx; zeros where not asked) in its accumulation dtype
    (float32 for bfloat16/float16), or None when no dot is asked.  Where
    that dtype is complex, an operand of another dtype is first widened to
    it (exactly), so the kernel sees one complex dtype; ``a`` and ``b`` may
    then be complex.  A coefficient on the card is read there, never on
    the host.  Returns ``(y', dots)``.
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
    if bw < 1:
        raise ValueError(f"{fn}: bw={bw} must be at least 1")
    check_operand(fn, "x", x, device, x.dtype, (n, bw))
    check_operand(fn, "y", y, device, y.dtype, (n, bw))
    out_dtype = torch.promote_types(x.dtype, y.dtype)
    if out_dtype.is_complex:
        x, y = x.to(out_dtype), y.to(out_dtype)
    acc = storage_acc_dtype(out_dtype)
    ca = coefficient_arg(fn, "a", a, acc, device, bw)
    cb = coefficient_arg(fn, "b", b, acc, device, bw)
    flags = ((_DOT_YY if dot_yy else 0) | (_DOT_XY if dot_xy else 0)
             | (_DOT_XX if dot_xx else 0))
    out = torch.empty((n, bw), dtype=out_dtype, device=device)
    if n == 0 and not flags:
        return out, None
    p = partition(n, bw, out_dtype)
    part = gpart = dots = counters = None
    stream = torch.cuda.current_stream(device).cuda_stream
    if flags:
        dot_dtype = torch.complex128 if acc.is_complex else acc
        part = torch.empty((p.nbx + p.ngroups) * 3 * p.period,
                           dtype=dot_dtype, device=device)
        gpart = part[p.nbx * 3 * p.period:]
        dots = torch.empty((3, bw), dtype=acc, device=device)
        counters = _counter_workspace(device, stream)
    args = (DTYPE_CODES[x.dtype], DTYPE_CODES[y.dtype], x.data_ptr(),
            y.data_ptr(), ca.ptr, ca.width, ca.re, ca.im, cb.ptr, cb.width,
            cb.re, cb.im, out.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (part, gpart, counters, dots)),
            n, bw, p.period, p.slot_tiles, p.nbx, flags, stream)
    if device.index == torch.cuda.current_device():
        rc = _entry()(*args)
    else:
        with torch.cuda.device(device):
            rc = _entry()(*args)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    execution.count_launch(fn)
    return out, dots
