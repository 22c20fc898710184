"""Small Hermitian eigensolver on Hopper: the wrapper of ``csrc/herm_eig.cu``.

Replaces no TPU kernel.  ``torch.linalg.eigh`` on a CUDA tensor checks
its ``info`` on the host after every call, so each (b, b) eigensolve of
the block-Krylov iteration (``solvers/block.py``) stalls the host; the
JAX package's ``jnp.linalg.eigh`` inside a jitted loop does not.  This
kernel computes the decomposition with the flag left on the device: one
thread block a matrix, cyclic Jacobi in shared memory up to m =
:data:`SHARED_DIM`, block Jacobi past it (pairs of blocks of
:data:`BLOCK` indices solved a warp each, their factors applied as small
products; U, and what shared memory cannot hold, in a workspace in
device memory; see the note at the top of the CUDA source).

``herm_eig_cuda(A)`` takes ``(m, m)`` or ``(batch, m, m)`` CUDA tensors in
float64, float32, complex128 or complex64 of any ``m >= 1``, reads their
lower triangles (as ``torch.linalg.eigh`` does) and returns ``(w, U,
sweeps)``: the eigenvalues ascending in the real dtype, the
eigenvectors as U's columns, and an int32 tensor on the card with the
Jacobi sweeps each matrix took, 0 where it did not converge within the
kernel's sweep limit.  Nothing else runs instead.
The plain version is ``torch.linalg.eigh``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import execution
from repro_torch.kernels import _build
from repro_torch.kernels.tsmttsm import DTYPE_CODES

__all__ = ["herm_eig_cuda", "SHARED_DIM", "DTYPES", "BLOCK", "wide_order",
           "work_values"]

#: largest m whose A and U the kernel keeps in shared memory (complex128
#: at 64 takes 128 KB); wider matrices take the wide instance
SHARED_DIM = 64
DTYPES = (torch.float64, torch.float32, torch.complex128, torch.complex64)
#: indices a block of the wide instance's order (``kBW`` of the CUDA
#: source); a pair of blocks is one warp's subproblem
BLOCK = 8
#: the dtype a wide matrix of a single-precision dtype is solved in
_DOUBLE = {torch.float32: torch.float64, torch.complex64: torch.complex128}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _I, _I, _P]


def wide_order(m: int) -> int:
    """The order the wide instance solves at: ``m`` rounded up to whole
    pairs of blocks (zero rows and columns, never rotated)."""
    return -(-m // (2 * BLOCK)) * 2 * BLOCK


def work_values(m: int) -> int:
    """Values of the workspace one matrix takes (0 up to
    :data:`SHARED_DIM`): U^T (mp x m), A (mp x (mp + 4)), and for each of
    the mp / 16 pairs its subproblem (16 x 17) and two rounds' factors (16
    x 18 each), as ``herm_eig_work_values`` of the CUDA source counts
    them."""
    if m <= SHARED_DIM:
        return 0
    mp = wide_order(m)
    pairs = mp // (2 * BLOCK)
    return m * mp + mp * (mp + 4) + pairs * (16 * 17 + 2 * 16 * 18)


def _entry():
    fn = _build.load("herm_eig").herm_eig_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def herm_eig_cuda(A: torch.Tensor):
    """Run the eigensolver on the card: ``A = U diag(w) U^H``.

    Returns ``(w, U, sweeps)`` with the shapes of ``torch.linalg.eigh``
    and ``sweeps`` of A's batch shape (0-d for one matrix).
    """
    fn = "herm_eig"
    device = A.device
    if device.type != "cuda":
        raise ValueError(f"herm_eig_cuda takes CUDA tensors, A is on {device}")
    if A.dtype not in DTYPES:
        raise TypeError(f"{fn}: no kernel for {A.dtype}")
    if A.ndim not in (2, 3) or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"{fn}: A must be (m, m) or (batch, m, m), got "
                         f"{tuple(A.shape)}")
    m = int(A.shape[-1])
    if m < 1:
        raise ValueError(f"{fn}: m={m} must be at least 1")
    batch_shape = tuple(A.shape[:-2])
    if m > SHARED_DIM and A.dtype in _DOUBLE:
        # past the shared-memory design a float32 (complex64) matrix is
        # solved in float64 (complex128): over the sweeps at m = 128 a
        # float32 U drifted from orthonormal by more than 16 m eps
        w, U, conv = herm_eig_cuda(A.to(_DOUBLE[A.dtype]))
        return w.to(A.real.dtype if A.is_complex() else A.dtype), \
            U.to(A.dtype), conv
    A = A.resolve_conj().contiguous()
    batch = int(A.shape[0]) if A.ndim == 3 else 1
    real = A.real.dtype if A.is_complex() else A.dtype
    w = torch.empty(batch_shape + (m,), dtype=real, device=device)
    U = torch.empty(tuple(A.shape), dtype=A.dtype, device=device)
    conv = torch.empty(batch_shape, dtype=torch.int32, device=device)
    if batch == 0:
        return w, U, conv
    # the wide instance's workspace: U, and what shared memory cannot hold
    work = (torch.empty(batch * work_values(m), dtype=A.dtype, device=device)
            if m > SHARED_DIM else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _entry()(DTYPE_CODES[A.dtype], A.data_ptr(), w.data_ptr(),
                      U.data_ptr(), conv.data_ptr(),
                      None if work is None else work.data_ptr(), batch, m,
                      stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    execution.count_launch(fn)
    return w, U, conv
