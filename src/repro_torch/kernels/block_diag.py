"""Batched block-diagonal matmul on Hopper: the wrapper of ``csrc/block_diag.cu``.

The CUDA port of ``repro/kernels/block_diag.py:block_diag_matmul_pallas``
(B4), the block-Jacobi apply: ``y[k*bs:(k+1)*bs] = B_k x[k*bs:(k+1)*bs]``
for an ``(nblocks, bs, bs)`` stack and ``x`` of shape ``(nblocks*bs, b)``.
A thread block stages a few whole diagonal blocks and their rows of ``x``
in shared memory and one thread forms one output row; past ``bs = 64`` a
persistent grid streams the diagonal blocks' rows through a ring of
shared-memory stages, each block's slice of ``x`` staged once (see the
note at the top of the CUDA source), for real blocks and for complex
ones, at any ``bs``.  This
wrapper validates the operands, allocates the result in
``promote_types(blocks, x)`` and launches on the current
stream without synchronising.  It needs no padding and has no
``row_tile``: any ``nblocks`` and ``b`` go through as they are.

It takes CUDA tensors only and raises on anything the kernel does not
take; the plain version is ``repro_torch.kernels.ref.block_diag_matmul_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import execution
from repro_torch.kernels import _build
from repro_torch.kernels.sellcs_spmv import check_operand
from repro_torch.kernels.tsmttsm import DTYPE_CODES

__all__ = ["block_diag_cuda", "check_shapes", "REAL_OF"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the real dtype of a complex one's precision
REAL_OF = {torch.complex128: torch.float64, torch.complex64: torch.float32}
_ARGTYPES = [_I, _I, _P, _P, _P, _L, _I, _I, _P]


def _entry():
    fn = _build.load("block_diag").block_diag_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_shapes(fn: str, blocks: torch.Tensor, x: torch.Tensor) -> None:
    """Raise unless ``blocks`` is ``(nblocks, bs, bs)`` and ``x`` is
    ``(nblocks*bs, b)`` (the JAX kernel's contract)."""
    if blocks.ndim != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"{fn}: blocks must be (nblocks, bs, bs), got "
                         f"{tuple(blocks.shape)}")
    nb, bs, _ = (int(s) for s in blocks.shape)
    if x.ndim != 2 or x.shape[0] != nb * bs:
        raise ValueError(f"{fn}: x rows ({tuple(x.shape)}) != nblocks*bs "
                         f"({nb}*{bs})")


def block_diag_cuda(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Run the block-diagonal matmul kernel on the card.

    ``blocks`` ``(nblocks, bs, bs)`` and ``x``
    ``(nblocks*bs, b)`` may have different real dtypes; complex blocks take
    an ``x`` of their dtype or a real one of their precision, complex64
    blocks a complex128 ``x`` too.  The result is ``(nblocks*bs, b)`` in
    ``promote_types(blocks, x)``, summed in its accumulation dtype
    (float32 for bfloat16/float16).  The other pairs go through
    ``kernels/ops.py:block_jacobi_apply``, which rearranges or widens them
    exactly.
    """
    fn = "block_diag_matmul"
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"block_diag_cuda takes CUDA tensors, x is on "
                         f"{device}")
    for name, t in (("blocks", blocks), ("x", x)):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{fn}: no kernel for {name} of {t.dtype}")
    if blocks.is_complex() or x.is_complex():
        taken = (blocks.dtype, REAL_OF.get(blocks.dtype)) + (
            (torch.complex128,) if blocks.dtype == torch.complex64 else ())
        if x.dtype not in taken:
            raise TypeError(f"{fn}: complex operands need complex blocks and "
                            f"x of their dtype or precision (or complex128 x "
                            f"with complex64 blocks), got blocks "
                            f"{blocks.dtype} and x {x.dtype}")
    check_shapes(fn, blocks, x)
    nb, bs, _ = (int(s) for s in blocks.shape)
    n, b = (int(s) for s in x.shape)
    out_dtype = torch.promote_types(blocks.dtype, x.dtype)
    check_operand(fn, "blocks", blocks, device, blocks.dtype, (nb, bs, bs))
    check_operand(fn, "x", x, device, x.dtype, (n, b))
    out = torch.empty((n, b), dtype=out_dtype, device=device)
    if nb == 0 or b == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _entry()(DTYPE_CODES[blocks.dtype], DTYPE_CODES[x.dtype],
                      blocks.data_ptr(), x.data_ptr(), out.data_ptr(), nb, bs,
                      b, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    execution.count_launch(fn)
    return out
