"""Selective-SSM (Mamba) scan on Hopper: the wrapper of ``csrc/mamba_scan.cu``.

The CUDA port of ``repro/kernels/mamba_scan.py:mamba_scan_pallas`` (B6):
``h <- exp(dt * A) h + dt * xc * Bc`` and ``y = sum_n h * Cc``, recurrent
over the whole sequence, with the state never written to device memory.
Each channel ``(b, d)`` belongs to one thread at ``N <= 16`` (up to 32
neighbouring threads above, 16 states each; past 512 states the scan
runs once a group of 512, adding to ``y``), which keeps its states and
its row of ``A log2(e)`` in registers and takes each exponential as one
``ex2.approx.ftz.f32`` (see the note at the top of the CUDA source;
``error_bound`` charges that exponential's error).  This wrapper
validates the operands, allocates ``y`` and launches on the current stream
without synchronising.  It has no ``d_tile`` and no ``s_blk``, and needs
no padding: any ``B``, ``S``, ``d_inner`` and ``N`` go through as they
are (more than 65,535 batch rows in several launches).

It takes contiguous float32 CUDA tensors only and raises on anything
else; the plain version is
``repro_torch.kernels.ref.mamba_scan_ref``.  ``exp2_cuda`` applies the
kernel's exponential alone, so that its error can be measured.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import execution
from repro_torch.kernels import _build
from repro_torch.kernels.ref import scan_chunks
from repro_torch.kernels.sellcs_spmv import check_operand

__all__ = ["mamba_scan_cuda", "exp2_cuda", "check_shapes", "error_bound",
           "EXP_ULP", "EXP_REL", "EXP_FLUSH"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 4 + [_P]


def _entry(name="mamba_scan_launch", argtypes=_ARGTYPES):
    fn = getattr(_build.load("mamba_scan"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_shapes(fn: str, dt, xc, Bc, Cc, A):
    """``(B, S, di, N)`` of the operands; raise unless ``dt`` and ``xc`` are
    ``(B, S, di)``, ``Bc`` and ``Cc`` ``(B, S, N)`` and ``A`` ``(di, N)``
    (the JAX kernel's contract)."""
    if dt.ndim != 3 or tuple(xc.shape) != tuple(dt.shape):
        raise ValueError(f"{fn}: dt{tuple(dt.shape)} and xc"
                         f"{tuple(xc.shape)} must both be (B, S, di)")
    B, S, di = (int(s) for s in dt.shape)
    if A.ndim != 2 or A.shape[0] != di:
        raise ValueError(f"{fn}: A{tuple(A.shape)} must be (di={di}, N)")
    N = int(A.shape[1])
    for name, t in (("Bc", Bc), ("Cc", Cc)):
        if tuple(t.shape) != (B, S, N):
            raise ValueError(f"{fn}: {name}{tuple(t.shape)} must be "
                             f"(B, S, N) = {(B, S, N)}")
    return B, S, di, N


#: float32's unit roundoff
_U = 2.0 ** -24
#: twice float32's smallest subnormal: what one rounding near underflow
#: may lose in absolute terms
_TINY = 2.0 ** -148
#: the kernel's exponential, ``ex2.approx.ftz.f32``: at most EXP_ULP units
#: in the last place from the correctly rounded 2^x (NVIDIA states its
#: error in ulp; this constant is the largest chip_smoke.py measures on
#: the card), so within EXP_ULP + 1/2 ulp of 2^x, a relative EXP_REL (an
#: ulp is at most 2u of the value); and a result below 2^-126 flushed to
#: 0, an absolute error of at most EXP_FLUSH.  chip_smoke.py holds all
#: three over every float32 argument <= 0 (``exp2_cuda``).
EXP_ULP = 2
EXP_REL = (2 * EXP_ULP + 1) * _U
EXP_FLUSH = 2.0 ** -126


def error_bound(dt, xc, Bc, Cc, A) -> torch.Tensor:
    """A bound on ``|y_kernel - y|`` for each output, with ``y`` the exact
    scan of the same float32 inputs, computed in float64, ``(B, S, di)``.

    Per channel and state the kernel forms ``a = ex2(fl(dt fl(A fl(log2
    e))))`` and ``b = dt xc Bc`` (two roundings), ``h = a h + b`` (charged
    one rounding each for the product and the sum), then ``y = sum_n h
    Cc`` (``N`` roundings).  The exponential's error, derived term by term:

    * ``ex2.approx.ftz.f32`` is within ``EXP_ULP`` = 2 ulp of the
      correctly rounded ``2^x`` where ``2^x >= 2^-126``: 2.5 ulp of the
      exact value, a relative ``EXP_REL = 5u``;
    * its argument is ``dt A log2(e) (1 + d)`` with ``|d| <= 3u``: one
      rounding each in the constant ``log2(e)``, in ``a2 = A log2(e)``
      (formed once per channel) and in ``dt a2``.  That multiplies the
      result by ``exp(dt A d)``, a relative ``3 |dt A| u`` to first order
      (``expf`` on ``fl(dt A)`` had one rounding here, ``|dt A| u``);
    * ``.ftz`` flushes a result below ``2^-126`` to 0 (and a subnormal
      argument to 0, whose ``2^x`` rounds to 1 anyway): an absolute error
      of at most ``EXP_FLUSH = 2^-126`` on each factor ``a``.

    To first order the state's error ``E`` then obeys

        E_s = a E_{s-1} + ((7 + 3 |dt A|) u a + 2^-126) H_{s-1} + 3 u |b| + tiny
        H_s = a H_{s-1} + |b|

    (``7u`` = the exponential's ``5u`` plus the product and the sum), with
    ``H`` the same recurrence on magnitudes (``|a| <= 1`` since ``A <= 0``,
    so no error grows), ``u = 2^-24`` and ``tiny = 2^-148`` for a rounding
    near underflow; and ``|dy| <= sum_n |Cc| E + N u sum_n |Cc| H``.  The
    bound returned is twice that, for the second-order terms.  It is never
    below the bound of an ``expf`` within 2 ulp on ``fl(dt A)``: every term
    is at least as large.
    """
    dt, xc, Bc, Cc, A = (t.double() for t in (dt, xc, Bc, Cc, A))
    B, S, di = dt.shape
    N = A.shape[1]
    exp_rel = EXP_REL / _U + 2                 # u per step: ex2, product, sum
    H = torch.zeros((B, di, N), dtype=torch.float64, device=dt.device)
    E = torch.zeros_like(H)
    out = torch.empty((B, S, di), dtype=torch.float64, device=dt.device)
    for s0, s1 in scan_chunks(S, H.numel()):    # several steps at once
        z = dt[:, s0:s1, :, None] * A
        a = torch.exp(z)
        b = ((dt[:, s0:s1] * xc[:, s0:s1])[..., None]
             * Bc[:, s0:s1, None, :]).abs()
        grow = (exp_rel + 3.0 * z.abs()) * _U * a + EXP_FLUSH
        fresh = 3.0 * _U * b
        c = Cc[:, s0:s1].abs()[:, :, None, :]
        for j in range(s1 - s0):
            E = a[:, j] * E + grow[:, j] * H + fresh[:, j] + _TINY
            H = a[:, j] * H + b[:, j]
            out[:, s0 + j] = 2.0 * ((c[:, j] * E).sum(-1)
                                    + N * _U * (c[:, j] * H).sum(-1))
    return out


def mamba_scan_cuda(dt: torch.Tensor, xc: torch.Tensor, Bc: torch.Tensor,
                    Cc: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Run the selective scan on the card: ``y`` ``(B, S, di)`` float32."""
    fn = "mamba_scan"
    device = dt.device
    if device.type != "cuda":
        raise ValueError(f"mamba_scan_cuda takes CUDA tensors, dt is on "
                         f"{device}")
    B, S, di, N = check_shapes(fn, dt, xc, Bc, Cc, A)
    if N < 1:
        raise ValueError(f"{fn}: N={N} must be at least 1")
    for name, t, shape in (("dt", dt, (B, S, di)), ("xc", xc, (B, S, di)),
                           ("Bc", Bc, (B, S, N)), ("Cc", Cc, (B, S, N)),
                           ("A", A, (di, N))):
        check_operand(fn, name, t, device, torch.float32, shape)
    y = torch.empty((B, S, di), dtype=torch.float32, device=device)
    if y.numel() == 0:
        return y                               # nothing to launch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _entry()(dt.data_ptr(), xc.data_ptr(), Bc.data_ptr(),
                      Cc.data_ptr(), A.data_ptr(), y.data_ptr(), B, S, di, N,
                      stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    execution.count_launch(fn)
    return y


def exp2_cuda(x: torch.Tensor) -> torch.Tensor:
    """The scan's exponential, ``ex2.approx.ftz.f32``, applied to each
    entry of a contiguous float32 CUDA tensor ``x``: ``2^x`` as the kernel
    takes it (for measuring its error; the scan itself never calls this)."""
    fn = "mamba_exp2"
    if x.device.type != "cuda":
        raise ValueError(f"exp2_cuda takes CUDA tensors, x is on {x.device}")
    check_operand(fn, "x", x, x.device, torch.float32, tuple(x.shape))
    r = torch.empty_like(x)
    if r.numel() == 0:
        return r
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry("mamba_exp2_launch", [_P, _P, ctypes.c_longlong, _P])(
            x.data_ptr(), r.data_ptr(), x.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    execution.count_launch(fn)
    return r
