"""Conjugate Gradient solvers on GHOST building blocks, in PyTorch.

* ``cg``: CG for SPD systems, one system per block-vector column
  (multiple right-hand sides, solved independently with ``block=False``).
  The matvec is fused with the <p, Ap> dot (GHOST_SPMV_DOT_XY), so one
  iteration is one launch of the SpMV kernel.
* ``pipelined_cg``: Ghysels & Vanroose pipelined CG, whose reduction
  bundle is independent of the matvec ``q = A w``.

Both are **resumable steppers**: ``*_init`` builds the state, ``*_step``
advances it by up to ``k`` iterations (per-column ``done`` carried in the
state), ``*_finalize`` reads out a :class:`CGResult`.  The classic entry
points compose the three and equal one monolithic solve bit for bit.

``block=True`` shares one Krylov space across the columns (BCGrQ block
CG, :mod:`repro_torch.solvers.block`, on the tall-skinny kernels); a
one-column right-hand side goes to the plain stepper, as in the JAX
package.

``cg`` takes an optional SPD preconditioner ``M`` (see
:mod:`repro_torch.solvers.precond`): ``M=None`` runs the plain
:class:`CGState` stepper unchanged, a preconditioner switches to the
:class:`PrecondCGState` stepper whose ``z = M r`` rides in the state.
Convergence is still tested on the true residual ``||r||``.  As in the
JAX package, ``block=True`` and ``pipelined_cg`` refuse a preconditioner.

Vectors are ``(n, b)`` in operator (permuted) space.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.spmv import SpmvOpts, as2d
from repro_torch.solvers.block import BlockCGState, block_cg_body, block_cg_init
from repro_torch.solvers.stepper import run_chunk

__all__ = ["CGResult", "CGState", "PrecondCGState", "PCGState", "cg",
           "cg_init", "cg_step",
           "cg_finalize", "pipelined_cg", "pipelined_cg_init",
           "pipelined_cg_step", "pipelined_cg_finalize"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int                 # total iteration count
    resnorm: torch.Tensor      # per-column final ||r||
    converged: torch.Tensor    # per-column bool


class CGState(NamedTuple):
    """Resumable block-CG state (columns = independent systems)."""

    x: torch.Tensor            # (n, b) iterate
    r: torch.Tensor            # (n, b) residual
    p: torch.Tensor            # (n, b) search direction
    rr: torch.Tensor           # (b,)   <r, r> recurrence
    tol2: torch.Tensor         # (b,)   per-column squared abs tolerance
    it: int                    # block iteration counter
    maxiter: int               # block iteration cap
    done: torch.Tensor         # (b,)   per-column convergence flag


class PrecondCGState(NamedTuple):
    """Resumable preconditioned CG state (``z = M r`` recurrence).

    ``rr`` (true squared residual norm, always real) drives the
    ``done``/``tol`` test exactly like plain CG; ``rz = <r, z>`` is the
    PCG recurrence scalar.
    """

    x: torch.Tensor            # (n, b) iterate
    r: torch.Tensor            # (n, b) residual
    z: torch.Tensor            # (n, b) preconditioned residual M r
    p: torch.Tensor            # (n, b) search direction
    rz: torch.Tensor           # (b,)   <r, z> recurrence
    rr: torch.Tensor           # (b,)   true ||r||^2 (real)
    tol2: torch.Tensor         # (b,)   per-column squared abs tolerance
    it: int                    # block iteration counter
    maxiter: int               # block iteration cap
    done: torch.Tensor         # (b,)   per-column convergence flag


class PCGState(NamedTuple):
    """Resumable pipelined-CG state (Ghysels & Vanroose carries)."""

    x: torch.Tensor
    r: torch.Tensor
    w: torch.Tensor
    z: torch.Tensor
    s: torch.Tensor
    p: torch.Tensor
    gamma_prev: torch.Tensor   # (b,)
    alpha_prev: torch.Tensor   # (b,)
    tol2: torch.Tensor         # (b,)
    fresh: torch.Tensor        # (b,)  column has not taken its first step yet
    it: int
    maxiter: int
    done: torch.Tensor         # (b,)


def _colsum(v: torch.Tensor) -> torch.Tensor:
    """Per-column squared norm, always real."""
    if v.is_complex():
        return torch.sum((torch.conj(v) * v).real, dim=0)
    return torch.sum(v * v, dim=0)


def _inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-column <a, b> with the conjugate-linear first argument."""
    if a.is_complex() or b.is_complex():
        return torch.sum(torch.conj(a) * b, dim=0)
    return torch.sum(a * b, dim=0)


def _maybe_1d(res: CGResult, was1d: bool) -> CGResult:
    if not was1d:
        return res
    return CGResult(res.x[:, 0], res.iters, res.resnorm[0], res.converged[0])


def _tol2(tol, bnorm2: torch.Tensor) -> torch.Tensor:
    """Squared relative tolerance, per column (``tol`` scalar or (b,)),
    floored at ``tiny`` so a (near-)zero rhs column can still finish."""
    t = torch.as_tensor(tol, dtype=bnorm2.dtype,
                        device=bnorm2.device).broadcast_to(bnorm2.shape)
    return torch.clamp_min((t * t) * bnorm2, torch.finfo(bnorm2.dtype).tiny)


def _no_pipelined_precond(M) -> None:
    if M is not None:
        raise NotImplementedError(
            "pipelined_cg does not support preconditioning: the Ghysels & "
            "Vanroose preconditioned variant needs an extra u = M r carry "
            "that this stepper does not yet implement.  Use cg(..., M=M) "
            "(preconditioned CG) or drop the preconditioner.")


def _start(op, b: torch.Tensor, x0: Optional[torch.Tensor]):
    """Initial ``(b2, x, r)``: zero-rhs columns are solved by ``x = 0`` on
    the spot, which makes their residual exactly zero."""
    b2, _ = as2d(b)
    x = torch.zeros_like(b2) if x0 is None else as2d(
        torch.as_tensor(x0, device=b2.device))[0]
    bzero = _colsum(b2) <= 0
    x = torch.where(bzero[None, :], torch.zeros((), dtype=b2.dtype,
                                                device=b2.device), x)
    return b2, x, b2 - op.mv(x)


# ------------------------------------------------------------------ plain CG
def cg_init(op, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
            tol=1e-8, maxiter: int = 500, M=None,
            block: bool = False):
    """Initial stepper state.  ``tol`` may be a scalar or per-column (b,).

    ``M=None`` returns the plain :class:`CGState`; an SPD preconditioner
    (``M.apply(r)`` in operator space) returns a :class:`PrecondCGState`.

    ``block=True`` with more than one column returns a
    :class:`~repro_torch.solvers.block.BlockCGState` (one Krylov space for
    all columns) and refuses a preconditioner; a one-column rhs gets the
    plain stepper, as in the JAX package.
    """
    if block and as2d(b)[0].shape[1] > 1:
        if M is not None:
            raise NotImplementedError(
                "cg(block=True) does not support preconditioning yet; "
                "drop M or use the column-wise block=False stepper")
        return block_cg_init(op, as2d(b)[0], x0, tol=tol, maxiter=maxiter)
    b2, x, r = _start(op, b, x0)
    rr = _colsum(r)
    bnorm2 = torch.clamp_min(_colsum(b2), torch.finfo(b2.dtype).tiny)
    tol2 = _tol2(tol, bnorm2)
    if M is None:
        return CGState(x=x, r=r, p=r, rr=rr, tol2=tol2, it=0,
                       maxiter=int(maxiter), done=rr <= tol2)
    z = M.apply(r)
    return PrecondCGState(x=x, r=r, z=z, p=z, rz=_inner(r, z), rr=rr,
                          tol2=tol2, it=0, maxiter=int(maxiter),
                          done=rr <= tol2)


def _cg_body(op, st: CGState) -> CGState:
    # fused: q = A p and <p, q> in one sweep (GHOST_SPMV_DOT_XY)
    q, _, dots = op.mv_fused(st.p, opts=SpmvOpts(dot_xy=True))
    # the dots accumulate in float64; cast the recurrence scalar back to
    # the vectors' dtype.  <p, Ap> is real for a Hermitian PD operator.
    pq = dots[1]
    if pq.is_complex():
        pq = pq.real
    pq = pq.to(st.rr.dtype)
    alpha = torch.where(st.done, 0.0, st.rr / torch.where(pq == 0, 1.0, pq))
    x = st.x + alpha[None, :] * st.p
    r = st.r - alpha[None, :] * q
    rr_new = _colsum(r)
    beta = rr_new / torch.where(st.rr == 0, 1.0, st.rr)
    p = torch.where(st.done[None, :], st.p, r + beta[None, :] * st.p)
    return CGState(x=x, r=r, p=p, rr=rr_new, tol2=st.tol2,
                   it=st.it + 1, maxiter=st.maxiter,
                   done=st.done | (rr_new <= st.tol2))


def _cg_precond_body(op, M, st: PrecondCGState) -> PrecondCGState:
    # fused: q = A p and <p, q> in one sweep (GHOST_SPMV_DOT_XY)
    q, _, dots = op.mv_fused(st.p, opts=SpmvOpts(dot_xy=True))
    pq = dots[1].to(st.rz.dtype)
    alpha = torch.where(st.done, 0.0, st.rz / torch.where(pq == 0, 1.0, pq))
    x = st.x + alpha[None, :] * st.p
    r = st.r - alpha[None, :] * q
    rr_new = _colsum(r)
    z = M.apply(r)
    rz_new = _inner(r, z)
    beta = rz_new / torch.where(st.rz == 0, 1.0, st.rz)
    p = torch.where(st.done[None, :], st.p, z + beta[None, :] * st.p)
    return PrecondCGState(x=x, r=r, z=z, p=p, rz=rz_new, rr=rr_new,
                          tol2=st.tol2, it=st.it + 1, maxiter=st.maxiter,
                          done=st.done | (rr_new <= st.tol2))


def cg_step(op, state, k: int, M=None):
    """Advance up to ``k`` iterations, stopping early when all columns are
    done or ``maxiter`` is reached.  Dispatches on the state's type; pass
    the same ``M`` the state was initialized with (``None`` for a plain
    :class:`CGState`)."""
    if isinstance(state, BlockCGState):
        if M is not None:
            raise ValueError("block CG states are unpreconditioned; "
                             "M must be None")
        return run_chunk(op, "block_cg", k, state, block_cg_body)
    if M is None:
        if isinstance(state, PrecondCGState):
            raise ValueError("state was initialized with a preconditioner; "
                             "pass the same M to cg_step")
        return run_chunk(op, "cg", k, state, _cg_body)
    if not isinstance(state, PrecondCGState):
        raise ValueError("state was initialized without a preconditioner; "
                         "call cg_init(..., M=M) first")
    return run_chunk(op, "cg_precond", k, state, _cg_precond_body, M)


def cg_finalize(state) -> CGResult:
    return CGResult(state.x, state.it, torch.sqrt(state.rr), state.done)


def cg(op, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
       tol: float = 1e-8, maxiter: int = 500, M=None,
       block: bool = False) -> CGResult:
    """(P)CG.  ``op`` must be SPD; ``M`` too.  ``block=False`` solves the
    columns independently; ``block=True`` shares one Krylov space across
    them (see :func:`cg_init`)."""
    was1d = b.ndim == 1
    state = cg_init(op, b, x0, tol=tol, maxiter=maxiter, M=M, block=block)
    state = cg_step(op, state, maxiter, M=M)
    return _maybe_1d(cg_finalize(state), was1d)


# -------------------------------------------------------------- pipelined CG
def pipelined_cg_init(op, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
                      *, tol=1e-8, maxiter: int = 500, M=None,
                      block: bool = False) -> PCGState:
    """Initial pipelined-CG stepper state (unpreconditioned).  ``M`` and
    ``block`` exist for signature parity: a preconditioner and
    ``block=True`` raise, as in the JAX package."""
    _no_pipelined_precond(M)
    if block:
        raise NotImplementedError(
            "pipelined_cg has no block (shared Krylov space) mode; use "
            "cg(..., block=True) or minres(..., block=True)")
    b2, x, r = _start(op, b, x0)
    w = op.mv(r)
    bnorm2 = torch.clamp_min(_colsum(b2), torch.finfo(b2.dtype).tiny)
    tol2 = _tol2(tol, bnorm2)
    zeros = torch.zeros_like(b2)
    zcol = torch.zeros(b2.shape[1], dtype=r.dtype, device=r.device)
    return PCGState(x=x, r=r, w=w, z=zeros, s=zeros, p=zeros,
                    gamma_prev=zcol, alpha_prev=zcol, tol2=tol2,
                    fresh=torch.ones(b2.shape[1], dtype=torch.bool,
                                     device=r.device),
                    it=0, maxiter=int(maxiter), done=_colsum(r) <= tol2)


def _pcg_body(op, st: PCGState) -> PCGState:
    gamma = torch.sum(st.r * st.r, dim=0)
    delta = torch.sum(st.w * st.r, dim=0)
    q = op.mv(st.w)                      # independent of the reductions
    # per-column first-step flag: a refilled column starts its own
    # recurrence
    first = st.fresh
    beta = torch.where(
        first, 0.0,
        gamma / torch.where(st.gamma_prev == 0, 1.0, st.gamma_prev))
    denom = torch.where(
        first, delta,
        delta - beta * gamma
        / torch.where(st.alpha_prev == 0, 1.0, st.alpha_prev))
    alpha = gamma / torch.where(denom == 0, 1.0, denom)
    z = q + beta[None] * st.z
    s = st.w + beta[None] * st.s
    p = st.r + beta[None] * st.p
    a = torch.where(st.done, 0.0, alpha)
    x = st.x + a[None] * p
    r = st.r - a[None] * s
    w = st.w - a[None] * z
    done = st.done | (_colsum(r) <= st.tol2)
    return PCGState(x=x, r=r, w=w, z=z, s=s, p=p,
                    gamma_prev=gamma, alpha_prev=alpha, tol2=st.tol2,
                    fresh=torch.zeros_like(st.fresh),
                    it=st.it + 1, maxiter=st.maxiter, done=done)


def pipelined_cg_step(op, state: PCGState, k: int, M=None) -> PCGState:
    """Advance up to ``k`` iterations (``M`` must be None)."""
    _no_pipelined_precond(M)
    return run_chunk(op, "pipelined_cg", k, state, _pcg_body)


def pipelined_cg_finalize(state: PCGState) -> CGResult:
    return CGResult(state.x, state.it, torch.sqrt(_colsum(state.r)),
                    state.done)


def pipelined_cg(op, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
                 tol: float = 1e-8, maxiter: int = 500,
                 M=None) -> CGResult:
    """Pipelined CG (Ghysels & Vanroose 2013, Alg. 3), unpreconditioned."""
    was1d = b.ndim == 1
    state = pipelined_cg_init(op, b, x0, tol=tol, maxiter=maxiter, M=M)
    state = pipelined_cg_step(op, state, maxiter)
    return _maybe_1d(pipelined_cg_finalize(state), was1d)
