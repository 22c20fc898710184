"""Fused SELL-C-sigma SpM(M)V on Hopper: the wrapper of ``csrc/sellcs_spmv.cu``.

The CUDA port of ``repro/kernels/sellcs_spmv.py:sellcs_spmv_pallas`` (B1).
One thread block owns one C-row chunk, one thread one row; the kernel
computes ``y = alpha (A - gamma I) x + beta y_in``, the chained
``z = delta z_in + eta y`` and per-chunk float64 partial dots in one sweep
(see the note at the top of the CUDA source).  This wrapper validates the
operands, allocates the outputs, launches on the current stream without
synchronising, and sums the per-chunk dots over chunks in float64 as the
JAX wrapper does outside its ``pallas_call``.

It takes CUDA tensors only and raises on anything the kernel does not
take; the plain version is ``repro_torch.kernels.ref.sellcs_spmv_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import execution
from repro_torch.kernels import _build

__all__ = ["sellcs_spmv_cuda", "MAX_C"]

#: largest chunk height: one block of C threads (rounded up to whole warps)
MAX_C = 256

_STORE_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2,
                torch.float16: 3}
_COMPUTE_CODES = {torch.float64: 0, torch.float32: 1}
_HAS_YIN, _HAS_GAMMA, _CHAIN, _DOT_YY, _DOT_XY, _DOT_XX = 1, 2, 4, 8, 16, 32

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = [_I, _I] + [_P] * 11 + [_I] * 4 + [_D] * 4 + [_I, _P]


def _entry():
    fn = _build.load("sellcs_spmv").sellcs_spmv_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_operand(name: str, t: torch.Tensor, device: torch.device,
                   dtype: torch.dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"sellcs_spmv: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"sellcs_spmv: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"sellcs_spmv: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"sellcs_spmv: {name} must be contiguous")


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
    ``(3, b)`` float64 (rows yy, xy, xx; zeros where not requested) or
    None.  ``compute_dtype`` is the accumulation dtype (pass
    ``SellCS.dtype``); ``vals`` may be stored narrower.  ``x`` may have
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
    if torch.finfo(vals.dtype).bits > torch.finfo(ct).bits:
        raise TypeError(f"sellcs_spmv: stored {vals.dtype} is wider than "
                        f"compute {ct}")
    if x.ndim != 2:
        raise ValueError(f"sellcs_spmv: x must be (n, b), got {tuple(x.shape)}")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"sellcs_spmv: C={C} is outside 1..{MAX_C}")
    nchunks = int(chunk_off.shape[0])
    n_pad = nchunks * C
    b = int(x.shape[1])
    cap = int(vals.shape[0])
    _check_operand("vals", vals, device, vals.dtype, (cap,))
    _check_operand("cols", cols, device, torch.int32, (cap,))
    _check_operand("chunk_off", chunk_off, device, torch.int32, (nchunks,))
    _check_operand("chunk_len", chunk_len, device, torch.int32, (nchunks,))
    _check_operand("x", x, device, ct, tuple(x.shape))
    square = x.shape[0] == n_pad
    chain = delta is not None or eta is not None
    any_dot = dot_yy or dot_xy or dot_xx
    if (gamma is not None or dot_xy or dot_xx) and not square:
        raise ValueError("gamma shift / x-dots need a square (diag-aligned) part")
    if y_in is not None:
        _check_operand("y_in", y_in, device, ct, (n_pad, b))
    if chain:
        if z_in is None:
            raise ValueError("sellcs_spmv: chained axpby requires z_in")
        _check_operand("z_in", z_in, device, ct, (n_pad, b))
    g = None
    if gamma is not None:
        g = torch.as_tensor(gamma, dtype=ct, device=device).reshape(-1)
        if g.numel() not in (1, b):
            raise ValueError(f"gamma must be scalar or ({b},)")
        g = g.contiguous()

    y = torch.empty((n_pad, b), dtype=ct, device=device)
    z = torch.empty((n_pad, b), dtype=ct, device=device) if chain else None
    part = (torch.empty((nchunks, 3, b), dtype=torch.float64, device=device)
            if any_dot else None)
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
                _ptr(x), _ptr(y_in), _ptr(z_in if chain else None), _ptr(g),
                _ptr(y), _ptr(z), _ptr(part),
                nchunks, C, b, 0 if g is None else g.numel(),
                float(alpha), float(beta),
                0.0 if delta is None else float(delta),
                0.0 if eta is None else float(eta),
                flags, stream)
        if rc != 0:
            raise RuntimeError(f"sellcs_spmv: kernel launch failed with CUDA "
                               f"error {rc}")
        execution.count_launch("sellcs_spmv")
    dots = part.sum(dim=0) if any_dot else None
    return y, z, dots
