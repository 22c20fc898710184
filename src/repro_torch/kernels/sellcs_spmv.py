"""Fused SELL-C-sigma SpM(M)V on Hopper: the wrapper of ``csrc/sellcs_spmv.cu``.

The CUDA port of ``repro/kernels/sellcs_spmv.py:sellcs_spmv_pallas`` (B1).
One thread block owns one C-row chunk (a taller chunk is spread over
several, :func:`chunk_parts`), and :func:`launch_geometry` spreads
each row over a few threads that own neighbouring columns as 16-byte
vectors; the kernel computes ``y = alpha (A - gamma I) x + beta y_in``,
the chained ``z = delta z_in + eta y`` and float64 partial dots of each
block of chunks in one sweep (see the note at the top of the CUDA
source), for real and for complex64/complex128 values.  This wrapper
validates the operands, picks the launch geometry, allocates the outputs,
launches on the current stream without synchronising, and sums the
blocks' dots (:func:`dot_parts`) in float64 (complex128 for complex
values) as the JAX wrapper does outside its ``pallas_call``.

It takes CUDA tensors only and raises on anything the kernel does not
take; the plain version is ``repro_torch.kernels.ref.sellcs_spmv_ref``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import execution
from repro_torch.core.spmv import dot_acc_dtype
from repro_torch.kernels import _build

__all__ = ["sellcs_spmv_cuda", "check_operand", "launch_geometry",
           "chunk_parts", "dot_parts", "coefficient", "coefficient_arg",
           "Coef", "Geometry", "MAX_THREADS"]

#: threads of one block at most; a chunk whose rows need more is spread
#: over several blocks (:func:`chunk_parts`)
MAX_THREADS = 512
#: columns of one grid.y slice at most
_MAX_BW = 16
#: bytes of columns a thread owns for complex values, where b allows
COMPLEX_THREAD_BYTES = 32
#: chunks a block walks when it sums dots (``kDotChunks`` of the CUDA
#: source)
DOT_CHUNKS = 4

_STORE_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2,
                torch.float16: 3, torch.complex128: 4, torch.complex64: 5}
_COMPUTE_CODES = {torch.float64: 0, torch.float32: 1, torch.complex128: 2,
                  torch.complex64: 3}
_HAS_YIN, _HAS_GAMMA, _CHAIN, _DOT_YY, _DOT_XY, _DOT_XX = 1, 2, 4, 8, 16, 32

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = [_I, _I] + [_P] * 11 + [_I] * 9 + [_D] * 10 + [_P] * 4 + [_I, _P]


class Geometry(NamedTuple):
    bw: int        # columns of one grid.y slice (a power of two, <= 16)
    cpt: int       # columns of one thread, moved as one vector when > 1
    tpr: int       # threads of one row (tpr * cpt == bw)
    threads: int   # threads of one block (whole warps, <= MAX_THREADS)
    slices: int    # grid.y: column slices of bw


def launch_geometry(b: int, C: int, compute_dtype: torch.dtype,
                    vectors: bool = True, dots: bool = False) -> Geometry:
    """How the kernel spreads a chunk of ``C`` rows and ``b`` columns.

    A slice of ``bw`` columns (the smallest power of two >= ``b``, at most
    16) is split over ``tpr`` threads a row, each owning ``cpt``
    neighbouring columns: one 16-byte vector (2 float64 or 4 float32
    values) when ``b`` is a multiple of it and ``vectors`` allows (the
    operands lie on 16-byte boundaries), else one column.  Complex values
    without ``dots`` take :data:`COMPLEX_THREAD_BYTES` of columns where
    ``b`` allows (2 complex128 or 4 complex64 values, two vectors), else,
    as with dots, 16 bytes (2 complex64 values; a complex128 value is
    itself one vector), else one column.  So b=16 in float64 is 8 threads
    a row, b=4 two, b=1 one; complex128 b=16 is 8 threads without dots
    and 16 with them.  A block holds the chunk's ``C * tpr`` threads,
    rounded up to whole warps and capped at :data:`MAX_THREADS` (then the
    chunk is spread over :func:`chunk_parts` blocks)."""
    bw = 1
    while bw < min(b, _MAX_BW):
        bw *= 2
    cpt = 1
    if vectors:
        widths = ((COMPLEX_THREAD_BYTES, 16)
                  if compute_dtype.is_complex and not dots else (16,))
        for nbytes in widths:
            v = max(1, nbytes // compute_dtype.itemsize)
            if b % v == 0 and bw >= v:
                cpt = v
                break
    tpr = bw // cpt
    threads = min(-(-C * tpr // 32) * 32, MAX_THREADS)
    return Geometry(bw, cpt, tpr, threads, -(-b // bw))


def chunk_parts(C: int, geo: Geometry) -> int:
    """Thread blocks one chunk of ``C`` rows is spread over: 1 where its
    ``C * tpr`` threads fit in one block, else one block a ``threads /
    tpr`` rows (any ``C``: ELLPACK's one chunk of all rows spreads over
    the whole card)."""
    return -(-C // (geo.threads // geo.tpr))


def dot_parts(nchunks: int, parts: int = 1) -> int:
    """Rows of dot partials the kernel writes: one a block of
    :data:`DOT_CHUNKS` chunks, times the ``parts`` blocks each chunk is
    spread over (:func:`chunk_parts`)."""
    return -(-nchunks // DOT_CHUNKS) * parts


def _entry():
    fn = _build.load("sellcs_spmv").sellcs_spmv_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check_operand(fn: str, name: str, t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device`` (the kernels take nothing else), holding its own values:
    a conjugate view (``t.conj()`` of a contiguous complex tensor, which
    torch keeps as a flag over the unconjugated values) is refused."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    if t.is_conj():
        raise ValueError(f"{fn}: {name} is a conjugate view; pass "
                         f"{name}.resolve_conj()")


def _check(name, t, device, dtype, shape) -> None:
    check_operand("sellcs_spmv", name, t, device, dtype, shape)


def coefficient(fn: str, name: str, v, ct: torch.dtype):
    """``(real, imaginary)`` parts of a number or a 0-d tensor on the host;
    a real compute dtype takes real coefficients only.  A tensor on the
    card goes through :func:`coefficient_arg` instead: reading it here
    would wait for the card."""
    c = complex(v)
    if c.imag != 0 and not ct.is_complex:
        raise TypeError(f"{fn}: {name}={v} is complex but the compute dtype "
                        f"{ct} is real")
    return c.real, c.imag


class Coef(NamedTuple):
    """A coefficient as the kernels take it: by value, ``re + i im``, or,
    where ``values`` is set, through the pointer of those 1 or ``width``
    values on the card (in the compute dtype), which the host never
    reads."""
    re: float
    im: float
    values: Optional[torch.Tensor] = None

    @property
    def ptr(self):
        return None if self.values is None else self.values.data_ptr()

    @property
    def width(self) -> int:
        return 0 if self.values is None else int(self.values.numel())


def coefficient_arg(fn: str, name: str, v, ct: torch.dtype, device,
                    width: int = 1) -> Coef:
    """A coefficient (a number, a 0-d tensor, or ``width`` values) as a
    kernel takes it, without a host sync: a number, or a host tensor or
    array of one value, by value; a tensor on the card as its values in
    ``ct`` (converted on the card where its dtype differs); a host tensor
    or array of ``width`` values copied to ``device`` from pinned memory
    without blocking.  A real ``ct`` takes real coefficients only (a
    complex tensor on the card is refused by its dtype)."""
    if isinstance(v, (int, float, complex)):
        return Coef(*coefficient(fn, name, v, ct))
    if isinstance(v, torch.Tensor) and v.device.type != "cpu":
        if v.is_complex() and not ct.is_complex:
            raise TypeError(f"{fn}: {name} is a {v.dtype} tensor but the "
                            f"compute dtype {ct} is real")
        t = v.reshape(-1)
    elif not isinstance(v, torch.Tensor) and np.ndim(v) == 0:
        return Coef(*coefficient(fn, name, v, ct))
    else:
        t = (v if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.asarray(v))).reshape(-1)
        if t.numel() == 1:
            return Coef(*coefficient(fn, name, t[0], ct))
        if t.is_complex() and not ct.is_complex:
            raise TypeError(f"{fn}: {name} is complex but the compute dtype "
                            f"{ct} is real")
    if t.numel() not in (1, width):
        shape = v.shape if isinstance(v, torch.Tensor) else np.shape(v)
        raise ValueError(f"{fn}: {name} must be a scalar or ({width},), got "
                         f"{tuple(shape)}")
    t = t.resolve_conj().to(ct).contiguous()
    if t.device != torch.device(device):
        if t.device.type == "cpu":
            t = t.pin_memory()
        t = t.to(device, non_blocking=True)
    return Coef(0.0, 0.0, t)


def sellcs_spmv_cuda(
    vals: torch.Tensor,
    cols: torch.Tensor,
    chunk_off: torch.Tensor,
    chunk_len: torch.Tensor,
    x: torch.Tensor,                        # (n_x, b), permuted space
    y_in: Optional[torch.Tensor] = None,    # (nchunks*C, b)
    z_in: Optional[torch.Tensor] = None,
    gamma=None,                             # scalar or (b,) shift
    *,
    C: int,
    alpha=1.0,
    beta=0.0,
    delta=None,
    eta=None,
    dot_yy: bool = False,
    dot_xy: bool = False,
    dot_xx: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
):
    """Run the fused SELL-C-sigma SpMMV kernel on the card.

    Returns ``(y, z, dots)``: ``y`` (and ``z`` when ``delta``/``eta`` is
    given) of shape ``(nchunks*C, b)`` in the compute dtype, and ``dots``
    ``(3, b)`` float64, complex128 for complex values (rows yy, xy, xx with
    ``<u, v> = sum conj(u) v``; zeros where not requested) or None.
    ``compute_dtype`` is the accumulation dtype (``SellCS.dtype``, or the
    result dtype of a mixed call, ``kernels/ops.py``); ``vals`` may be
    stored in any dtype that promotes to it: narrower real values,
    complex64 under complex128, or real values under a complex compute
    dtype (a real matrix on complex vectors, two fused multiply-adds a
    product).
    ``alpha``, ``beta``, ``delta``, ``eta`` and ``gamma`` may be complex
    for a complex compute dtype.  ``x`` may have
    other than ``nchunks*C`` rows (a rectangular part), and then the
    gamma shift and the x-dots raise.
    """
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"sellcs_spmv_cuda takes CUDA tensors, x is on {device}")
    ct = vals.dtype if compute_dtype is None else compute_dtype
    if vals.dtype not in _STORE_CODES:
        raise TypeError(f"sellcs_spmv: no kernel for stored values of {vals.dtype}")
    if ct not in _COMPUTE_CODES:
        raise TypeError(f"sellcs_spmv: no kernel for compute dtype {ct}")
    if torch.promote_types(vals.dtype, ct) != ct:
        raise TypeError(f"sellcs_spmv: stored {vals.dtype} is wider than "
                        f"compute {ct}")
    if x.ndim != 2:
        raise ValueError(f"sellcs_spmv: x must be (n, b), got {tuple(x.shape)}")
    if C < 1:
        raise ValueError(f"sellcs_spmv: C={C} must be at least 1")
    nchunks = int(chunk_off.shape[0])
    n_pad = nchunks * C
    b = int(x.shape[1])
    cap = int(vals.shape[0])
    _check("vals", vals, device, vals.dtype, (cap,))
    _check("cols", cols, device, torch.int32, (cap,))
    _check("chunk_off", chunk_off, device, torch.int32, (nchunks,))
    _check("chunk_len", chunk_len, device, torch.int32, (nchunks,))
    _check("x", x, device, ct, tuple(x.shape))
    square = x.shape[0] == n_pad
    chain = delta is not None or eta is not None
    any_dot = dot_yy or dot_xy or dot_xx
    if (gamma is not None or dot_xy or dot_xx) and not square:
        raise ValueError("gamma shift / x-dots need a square (diag-aligned) part")
    if y_in is not None:
        _check("y_in", y_in, device, ct, (n_pad, b))
    if chain:
        if z_in is None:
            raise ValueError("sellcs_spmv: chained axpby requires z_in")
        _check("z_in", z_in, device, ct, (n_pad, b))
    g = (None if gamma is None else
         coefficient_arg("sellcs_spmv", "gamma", gamma, ct, device, b))

    y = torch.empty((n_pad, b), dtype=ct, device=device)
    z = torch.empty((n_pad, b), dtype=ct, device=device) if chain else None
    geo = launch_geometry(b, C, ct, all(
        t.data_ptr() % 16 == 0 for t in (x, y_in, z_in if chain else None)
        if t is not None), dots=any_dot)
    parts = chunk_parts(C, geo)
    part = (torch.empty((dot_parts(nchunks, parts), 3, b),
                        dtype=dot_acc_dtype(ct), device=device)
            if any_dot else None)
    coefs = [coefficient_arg("sellcs_spmv", name, v, ct, device)
             for name, v in (("alpha", alpha), ("beta", beta),
                             ("delta", 0.0 if delta is None else delta),
                             ("eta", 0.0 if eta is None else eta))]
    if n_pad and b:
        flags = ((_HAS_YIN if y_in is not None else 0)
                 | (_HAS_GAMMA if g is not None else 0)
                 | (_CHAIN if chain else 0)
                 | (_DOT_YY if dot_yy else 0)
                 | (_DOT_XY if dot_xy else 0)
                 | (_DOT_XX if dot_xx else 0))
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _entry()(
                _STORE_CODES[vals.dtype], _COMPUTE_CODES[ct],
                _ptr(vals), _ptr(cols), _ptr(chunk_off), _ptr(chunk_len),
                _ptr(x), _ptr(y_in), _ptr(z_in if chain else None),
                None if g is None else g.ptr, _ptr(y), _ptr(z), _ptr(part),
                nchunks, C, b, geo.bw, geo.tpr, geo.cpt, geo.threads, parts,
                0 if g is None else g.width,
                *(c.re for c in coefs), *(c.im for c in coefs),
                0.0 if g is None else g.re, 0.0 if g is None else g.im,
                *(c.ptr for c in coefs), flags, stream)
        if rc != 0:
            raise RuntimeError(f"sellcs_spmv: kernel launch failed with CUDA "
                               f"error {rc}")
        execution.count_launch("sellcs_spmv")
    dots = part.sum(dim=0) if any_dot else None
    return y, z, dots
