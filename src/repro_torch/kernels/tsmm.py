"""Tall-skinny x small GEMM on Hopper: the wrapper of ``csrc/tsmm.cu``.

The CUDA port of ``repro/kernels/tsmm.py:tsmm_pallas`` (B3):
``W_out = alpha * V X + beta * W`` for real or complex V ``(n, m)``, X
``(m, k)`` and W ``(n, k)`` or none, at any widths.  Up to m = k = 64 X is
kept in shared memory and each row of V and W is read once and each
output row written once; wider calls take a tiled instance, a block a
128 x 128 tile of the result (64 x 64 for complex values) walking m in
steps; float64 takes a persistent kernel on the FP64 tensor cores that
keeps X's slab in shared memory and streams V's rows (see the note at the
top of the CUDA source).  This wrapper validates the operands, hands X
over in the accumulation dtype, allocates the result and launches on the
current stream without synchronising.

It takes CUDA tensors only and raises on anything the kernel does not
take; the plain version is ``repro_torch.kernels.ref.tsmm_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import execution
from repro_torch.core.spmv import storage_acc_dtype
from repro_torch.kernels import _build
from repro_torch.kernels.sellcs_spmv import check_operand, coefficient_arg
from repro_torch.kernels.tsmttsm import DTYPE_CODES, check_dims

__all__ = ["tsmm_cuda"]

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_ARGTYPES = [_I, _P, _P, _P, _P, _L, _I, _I, _D, _D, _D, _D, _P, _P, _I, _P]


def _entry():
    fn = _build.load("tsmm").tsmm_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def tsmm_cuda(V: torch.Tensor, X: torch.Tensor,
              W: Optional[torch.Tensor] = None, alpha=1.0,
              beta=0.0) -> torch.Tensor:
    """Run the tsmm kernel on the card: ``alpha * V X + beta * W``.

    The result is ``(n, k)`` in ``promote_types(V, X)``, which must be V's
    dtype (X no wider than V, converted exactly: a complex V takes a
    complex X of its dtype or a real X of its precision;
    ``kernels/ops.py:tsmm`` widens V for the other pairs); W, when given,
    has that dtype too.  The products are summed in the accumulation dtype
    (float32 for bfloat16/float16).  ``alpha``/``beta`` are numbers or 0-d
    tensors (one on the card is read there, never on the host), complex
    ones for complex V only.
    """
    fn = "tsmm"
    device = V.device
    if device.type != "cuda":
        raise ValueError(f"tsmm_cuda takes CUDA tensors, V is on {device}")
    if V.dtype not in DTYPE_CODES:
        raise TypeError(f"{fn}: no kernel for {V.dtype}")
    if V.ndim != 2 or X.ndim != 2 or V.shape[1] != X.shape[0]:
        raise ValueError(f"{fn}: inner dims disagree: V{tuple(V.shape)} "
                         f"X{tuple(X.shape)}")
    if torch.promote_types(V.dtype, X.dtype) != V.dtype:
        raise TypeError(f"{fn}: X ({X.dtype}) must be no wider than V "
                        f"({V.dtype})")
    n, m = (int(s) for s in V.shape)
    k = int(X.shape[1])
    check_dims(fn, m, k)
    check_operand(fn, "V", V, device, V.dtype, (n, m))
    if X.device != device:
        raise ValueError(f"{fn}: X is on {X.device}, V on {device}")
    if W is not None:
        check_operand(fn, "W", W, device, V.dtype, (n, k))
    out = torch.empty((n, k), dtype=V.dtype, device=device)
    if n == 0:
        return out
    acc = storage_acc_dtype(V.dtype)
    xs = X.resolve_conj().to(acc).contiguous()
    ca, cb = (coefficient_arg(fn, name, v, acc, device)
              for name, v in (("alpha", alpha), ("beta", beta)))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _entry()(
            DTYPE_CODES[V.dtype], V.data_ptr(), xs.data_ptr(),
            None if W is None else W.data_ptr(), out.data_ptr(), n, m, k,
            ca.re, cb.re, ca.im, cb.im, ca.ptr, cb.ptr, int(W is not None),
            stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    execution.count_launch("tsmm")
    return out
