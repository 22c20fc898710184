"""MINRES for symmetric (possibly indefinite) systems, in PyTorch.

Standard Lanczos-based MINRES with Givens rotations, the block-vector
columns solved independently; ``block=True`` shares one Lanczos space
across the columns (:mod:`repro_torch.solvers.block`, on the tall-skinny
kernels), and a one-column right-hand side then goes to the plain
stepper, as in the JAX package.

Like CG, the solver is a **resumable stepper** (``minres_init`` /
``minres_step`` / ``minres_finalize``) with per-column ``done`` in the
state; the classic ``minres`` entry point composes the three and equals
one monolithic solve bit for bit.  Preconditioning (``M=``) needs the
block-Jacobi kernel, which is not ported yet: it raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.spmv import as2d
from repro_torch.solvers.block import (BlockMinresState, block_minres_body,
                                       block_minres_init)
from repro_torch.solvers.cg import _no_precond
from repro_torch.solvers.stepper import run_chunk

__all__ = ["MinresResult", "MinresState", "minres", "minres_init",
           "minres_step", "minres_finalize"]


def _colnorm2(v: torch.Tensor) -> torch.Tensor:
    """Per-column squared norm, always real."""
    if v.is_complex():
        return torch.sum((v.conj() * v).real, dim=0)
    return torch.sum(v * v, dim=0)


def _inner_real(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Real part of per-column <a, b> (conjugate-linear first argument)."""
    if a.is_complex() or b.is_complex():
        return torch.sum(a.conj() * b, dim=0).real
    return torch.sum(a * b, dim=0)


class MinresResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor
    converged: torch.Tensor


class MinresState(NamedTuple):
    """Resumable MINRES state (columns = independent systems)."""

    x: torch.Tensor            # (n, b) iterate
    v: torch.Tensor            # (n, b) current Lanczos vector
    v_old: torch.Tensor        # (n, b)
    w: torch.Tensor            # (n, b) update direction
    w_old: torch.Tensor        # (n, b)
    beta: torch.Tensor         # (b,)   Lanczos off-diagonal
    eta: torch.Tensor          # (b,)   rotated rhs residual coefficient
    c: torch.Tensor            # (b,)   Givens cosines / sines
    c_old: torch.Tensor
    s: torch.Tensor
    s_old: torch.Tensor
    resn: torch.Tensor         # (b,)   residual-norm estimate
    tolb: torch.Tensor         # (b,)   per-column absolute tolerance
    it: int
    maxiter: int
    done: torch.Tensor         # (b,)


def minres_init(op, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
                tol=1e-8, maxiter: int = 500, M=None, block: bool = False):
    """Initial stepper state.  ``tol`` may be a scalar or per-column (b,).

    ``block=True`` with more than one column returns a
    :class:`~repro_torch.solvers.block.BlockMinresState`; a one-column rhs
    gets the plain :class:`MinresState`, as in the JAX package.
    """
    _no_precond(M, "minres")
    b2, _ = as2d(b)
    if block and b2.shape[1] > 1:
        return block_minres_init(op, b2, x0, tol=tol, maxiter=maxiter)
    x = torch.zeros_like(b2) if x0 is None else as2d(
        torch.as_tensor(x0, device=b2.device))[0]
    # zero-rhs columns are solved by x = 0 on the spot (their residual is
    # then exactly zero, so they converge at init)
    bzero = _colnorm2(b2) <= 0
    x = torch.where(bzero[None, :], torch.zeros((), dtype=b2.dtype,
                                                device=b2.device), x)
    r = b2 - op.mv(x)
    tiny = torch.finfo(b2.dtype).tiny
    bnorm = torch.sqrt(torch.clamp_min(_colnorm2(b2), tiny))
    # floored: a zero-b column's absolute tolerance must stay positive
    tolb = torch.clamp_min(
        torch.as_tensor(tol, dtype=bnorm.dtype,
                        device=bnorm.device).broadcast_to(bnorm.shape)
        * bnorm, tiny)

    beta1 = torch.sqrt(_colnorm2(r))
    v = r / torch.where(beta1 == 0, 1.0, beta1)[None]

    zeros = torch.zeros_like(b2)
    zcol = torch.zeros(b2.shape[1], dtype=bnorm.dtype, device=b2.device)
    return MinresState(
        x=x, v=v, v_old=zeros, w=zeros, w_old=zeros,
        beta=zcol, eta=beta1,
        c=torch.ones_like(zcol), c_old=torch.ones_like(zcol),
        s=zcol, s_old=zcol, resn=beta1, tolb=tolb,
        it=0, maxiter=int(maxiter), done=beta1 <= tolb)


def _minres_body(op, st: MinresState) -> MinresState:
    Av = op.mv(st.v)
    alpha = _inner_real(st.v, Av)
    r1 = Av - alpha[None] * st.v - st.beta[None] * st.v_old
    beta_new = torch.sqrt(_colnorm2(r1))
    v_new = r1 / torch.where(beta_new == 0, 1.0, beta_new)[None]

    # previous rotations applied to the new column of T
    delta = st.c * alpha - st.c_old * st.s * st.beta
    rho2 = st.s * alpha + st.c_old * st.c * st.beta
    rho3 = st.s_old * st.beta
    rho1 = torch.sqrt(delta * delta + beta_new * beta_new)
    rho1s = torch.where(rho1 == 0, 1.0, rho1)
    c_new = delta / rho1s
    s_new = beta_new / rho1s

    w_new = (st.v - rho3[None] * st.w_old - rho2[None] * st.w) / rho1s[None]
    upd = torch.where(st.done, 0.0, c_new * st.eta)
    x = st.x + upd[None] * w_new
    eta_new = -s_new * st.eta
    resn_new = torch.where(st.done, st.resn, torch.abs(eta_new))
    return MinresState(
        x=x, v=v_new, v_old=st.v, w=w_new, w_old=st.w,
        beta=beta_new, eta=eta_new,
        c=c_new, c_old=st.c, s=s_new, s_old=st.s,
        resn=resn_new, tolb=st.tolb,
        it=st.it + 1, maxiter=st.maxiter,
        done=st.done | (resn_new <= st.tolb))


def minres_step(op, state, k: int, M=None):
    """Advance up to ``k`` iterations, stopping early when all columns are
    done or ``maxiter`` is reached.  Dispatches on the state's type."""
    _no_precond(M, "minres_step")
    if isinstance(state, BlockMinresState):
        return run_chunk(op, "block_minres", k, state, block_minres_body)
    return run_chunk(op, "minres", k, state, _minres_body)


def minres_finalize(state) -> MinresResult:
    return MinresResult(state.x, state.it, state.resn, state.done)


def minres(op, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
           tol: float = 1e-8, maxiter: int = 500, M=None,
           block: bool = False) -> MinresResult:
    """MINRES, ``op`` symmetric.  ``block=True`` shares one Lanczos space
    across the columns (see :func:`minres_init`)."""
    was1d = b.ndim == 1
    state = minres_init(op, b, x0, tol=tol, maxiter=maxiter, M=M,
                        block=block)
    state = minres_step(op, state, maxiter, M=M)
    res = minres_finalize(state)
    if was1d:
        return MinresResult(res.x[:, 0], res.iters, res.resnorm[0],
                            res.converged[0])
    return res
