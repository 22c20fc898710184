"""Plain PyTorch versions of the port's CUDA kernels.

Each is the oracle its kernel is held against (on the card in
``chip_smoke.py`` and the ``gpu``-marked tests) and what the kernel
wrappers run for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import blockvec
from repro_torch.core.sellcs import SellCS
from repro_torch.core.spmv import SpmvOpts, spmv_ref, storage_acc_dtype

__all__ = ["sellcs_spmv_ref", "tsmttsm_ref", "tsmttsm_exact_entries",
           "tsmm_ref", "block_diag_matmul_ref", "fused_axpby_dots_ref", "mamba_scan_ref"]


def sellcs_spmv_ref(A: SellCS, x, y=None, z=None, opts: SpmvOpts = SpmvOpts()):
    """Plain version of B1: delegates to the core gather + ``index_add_``
    SpMV, which runs on any device."""
    return spmv_ref(A, x, y, z, opts)


def tsmttsm_ref(V, W, X=None, alpha=1.0, beta=0.0, *, kahan: bool = False,
                conj: bool = True):
    """Plain version of B2: ``blockvec.tsmttsm`` (or, with ``kahan``,
    ``blockvec.tsmttsm_kahan``), returned in ``promote_types(V, W)`` as the
    kernel returns it (the sums run in the accumulation dtype)."""
    out_dtype = torch.promote_types(V.dtype, W.dtype)
    if not kahan:
        return blockvec.tsmttsm(V, W, X, alpha=alpha, beta=beta,
                                conj=conj).to(out_dtype)
    blockvec.check_beta_needs_out(beta, X, "tsmttsm")
    # tsmttsm_kahan conjugates a complex V; pre-conjugate to honour
    # conj=False (V^T W instead of V^H W)
    Vk = V.conj() if (not conj and V.is_complex()) else V
    res = alpha * blockvec.tsmttsm_kahan(Vk, W)
    if X is not None:
        res = res + beta * X.to(res.dtype)
    return res.to(out_dtype)


#: values of one operand that :func:`tsmttsm_exact_entries` forms at once
#: (128 MB in float64)
EXACT_CHUNK = 1 << 24


def _two_sum(a, b):
    """``(s, e)`` with ``s = fl(a + b)`` and ``s + e = a + b`` exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(a, b):
    """:func:`_two_sum` for ``|a| >= |b|``."""
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b):
    """``(p, e)`` with ``p = fl(a b)`` and ``p + e = a b`` exactly
    (Dekker's product: each factor split into halves of 26 bits, whose
    products are exact, with no fused multiply-add needed)."""
    def split(x):
        t = x * 134217729.0                     # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _dd_sum(hi, lo):
    """The sums over dim 0 of the double-double values ``hi + lo``, as
    double-double ``(hi, lo)``: pairs added in a tree, each addition
    accurate to a few units of 2^-106 of its operands' magnitudes."""
    while hi.shape[0] > 1:
        if hi.shape[0] % 2:
            zero = torch.zeros_like(hi[:1])
            hi, lo = torch.cat([hi, zero]), torch.cat([lo, zero])
        s, e = _two_sum(hi[0::2], hi[1::2])
        t, f = _two_sum(lo[0::2], lo[1::2])
        s, e = _fast_two_sum(s, e + t)
        hi, lo = _fast_two_sum(s, e + f)
    return hi[0], lo[0]


def tsmttsm_exact_entries(V: torch.Tensor, W: torch.Tensor, rows, cols):
    """Entries ``(V^T W)[rows[i], cols[i]]`` of real float64 ``V`` (n, m)
    and ``W`` (n, k), summed as if exactly: ``(hi, lo)`` float64 tensors
    whose sum ``hi + lo`` errs by a few units of 2^-106 times
    ``log2(n) * sum |terms|`` (each product split exactly into two
    doubles, the 2 n parts summed in double-double).  The oracle for a
    compensated kernel, whose error the float64 plain version's own
    rounding (n units of 2^-53) would hide.  Runs on V's device."""
    if V.dtype != torch.float64 or W.dtype != torch.float64:
        raise TypeError(f"tsmttsm_exact_entries: float64 V and W, got "
                        f"{V.dtype} and {W.dtype}")
    rows = torch.as_tensor(rows, device=V.device).reshape(-1)
    cols = torch.as_tensor(cols, device=V.device).reshape(-1)
    n = V.shape[0]
    hi = torch.zeros(rows.numel(), dtype=torch.float64, device=V.device)
    lo = torch.zeros_like(hi)
    if n == 0:
        return hi, lo
    step = max(1, EXACT_CHUNK // n)
    for e0 in range(0, rows.numel(), step):
        p, e = _two_prod(V[:, rows[e0:e0 + step]], W[:, cols[e0:e0 + step]])
        hi[e0:e0 + step], lo[e0:e0 + step] = _dd_sum(p, e)
    return hi, lo


def tsmm_ref(V, X, W=None, alpha=1.0, beta=0.0):
    """Plain version of B3: ``blockvec.tsmm``."""
    return blockvec.tsmm(V, X, W, alpha=alpha, beta=beta)


def block_diag_matmul_ref(blocks: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Plain version of B4: ``y[k*bs:(k+1)*bs] = blocks[k] @ x[k*bs:(k+1)*bs]``
    for ``blocks`` ``(nblocks, bs, bs)`` and ``x`` ``(nblocks*bs, b)``, as a
    broadcast product summed over the block's columns in the accumulation
    dtype, returned in ``promote_types(blocks, x)`` as the kernels return
    it (the JAX reference's einsum returns the same type)."""
    nb, bs, _ = blocks.shape
    out_dtype = torch.promote_types(blocks.dtype, x.dtype)
    acc = storage_acc_dtype(out_dtype)
    xb = x.to(acc).reshape(nb, bs, x.shape[1])
    y = (blocks.to(acc)[:, :, :, None] * xb[:, None, :, :]).sum(dim=2)
    return y.reshape(nb * bs, x.shape[1]).to(out_dtype)


def fused_axpby_dots_ref(x: torch.Tensor, y: torch.Tensor, a=1.0, b=1.0, *,
                         dot_yy: bool = False, dot_xy: bool = False,
                         dot_xx: bool = False):
    """Plain version of B5: ``(a x + b y, dots (3, bw) or None)`` for
    ``(n, bw)`` blocks, with ``a``/``b`` scalars or ``(bw,)``.  ``y'`` and
    the dots are formed in the accumulation dtype of
    ``promote_types(x, y)``; ``y'`` is returned in that promoted dtype, as
    the Pallas kernel returns it (the JAX reference returns ``x``'s).
    Complex dots are conjugate-linear in their first argument and summed
    in complex128, then rounded to the accumulation dtype, as the kernel
    sums them."""
    out_dtype = torch.promote_types(x.dtype, y.dtype)
    acc = storage_acc_dtype(out_dtype)
    xf = x.to(acc)
    ynew = (torch.as_tensor(a, dtype=acc, device=x.device) * xf
            + torch.as_tensor(b, dtype=acc, device=x.device) * y.to(acc))
    dots = None
    if dot_yy or dot_xy or dot_xx:
        dacc = torch.complex128 if acc.is_complex else acc
        xd, yd = xf.to(dacc), ynew.to(dacc)
        zero = torch.zeros(x.shape[1], dtype=dacc, device=x.device)
        dots = torch.stack([
            torch.sum(torch.conj(yd) * yd, dim=0) if dot_yy else zero,
            torch.sum(torch.conj(xd) * yd, dim=0) if dot_xy else zero,
            torch.sum(torch.conj(xd) * xd, dim=0) if dot_xx else zero,
        ]).to(acc)
    return ynew.to(out_dtype), dots


def mamba_scan_ref(dt: torch.Tensor, xc: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Plain version of B6, the selective scan: a loop over the sequence in
    the dtype of its inputs (float64 inputs make it the card-side oracle).

    ``dt``, ``xc`` ``(B, S, di)``; ``Bc``, ``Cc`` ``(B, S, N)``; ``A``
    ``(di, N)``.  ``h <- exp(dt A) h + (dt xc) Bc`` from ``h = 0``, and
    ``y[:, s] = sum_n h Cc[:, s]``; returns ``y`` ``(B, S, di)``.  The
    factors ``exp(dt A)`` and inputs ``(dt xc) Bc`` of up to
    ``SCAN_CHUNK`` values are formed for several steps at once, so that
    the loop over the steps launches few operations.
    """
    B, S, di = dt.shape
    h = torch.zeros((B, di, A.shape[1]), dtype=dt.dtype, device=dt.device)
    y = torch.empty((B, S, di), dtype=dt.dtype, device=dt.device)
    for s0, s1 in scan_chunks(S, h.numel()):
        dts = dt[:, s0:s1]
        decay = torch.exp(dts[..., None] * A)           # (B, steps, di, N)
        inp = (dts * xc[:, s0:s1])[..., None] * Bc[:, s0:s1, None, :]
        for j in range(s1 - s0):
            h = decay[:, j] * h + inp[:, j]
            y[:, s0 + j] = torch.einsum("bdn,bn->bd", h, Cc[:, s0 + j])
    return y


#: values of one operand that a scan's plain loop forms for several steps
#: at once (32 MB in float64)
SCAN_CHUNK = 1 << 22


def scan_chunks(S: int, per_step: int):
    """``(start, stop)`` of the runs of steps a scan over ``S`` steps of
    ``per_step`` values each forms at once: at most ``SCAN_CHUNK`` values,
    at least one step."""
    step = max(1, SCAN_CHUNK // max(per_step, 1))
    return [(s0, min(S, s0 + step)) for s0 in range(0, S, step)]
