"""True block-Krylov steppers on the tall-skinny GEMM kernels.

All columns of a ``(n, b)`` right-hand side share **one Krylov space**,
so every iteration costs one block SpMV sweep (kernel B1) for the whole
block; the rest is tall-skinny dense algebra — Gram matrices ``Vᴴ·W``
through the Kahan-compensated :func:`repro_torch.kernels.ops.tsmttsm`
(kernel B2) and basis updates ``V·X`` through
:func:`repro_torch.kernels.ops.tsmm` (kernel B3) — plus ``(b, b)``
systems solved with ``torch.linalg`` (the paper's §5.2–5.3 case for
row-major block vectors).

* **Block CG** (Dubrulle's BCGrQ): the step coefficients are small
  ``(b, b)`` systems solved by Cholesky with an eigh-pinv fallback; the
  residual block is carried SVQB-orthonormalized.
* **Block MINRES**: block Lanczos with SVQB orthonormalization of the
  candidate block and an incremental band QR of the block tridiagonal via
  ``2b×2b`` orthogonal reflections.

Converged columns are deflated, not dropped: their columns are masked to
zero inside the shared space, so the live columns keep iterating while
the block shape stays fixed.  The carried ``(b, b)`` blocks couple every
column, so these states cannot be column-spliced (``BLOCK_COUPLED``).

The Cholesky→eigh fallback picks per call without a host
synchronisation: ``cholesky_ex``'s ``info == 0`` and a finite solve select
the Cholesky branch (``torch.linalg.cholesky`` would raise, and
``cholesky_ex`` returns a finite, wrong factor when it fails, where JAX
fills NaN).  The ``(b, b)`` eigendecompositions go through
:func:`repro_torch.kernels.ops.herm_eig`: on the card the port's Jacobi
kernel, which leaves its convergence flag on the device, where
``torch.linalg.eigh`` would check its ``info`` on the host every call; on
the CPU ``torch.linalg.eigh`` itself.  ``it``/``maxiter`` are Python
ints.

Entry points are not public API: use ``cg(..., block=True)`` /
``minres(..., block=True)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.spmv import as2d
from repro_torch.kernels import ops

__all__ = ["BlockCGState", "BlockMinresState",
           "block_cg_init", "block_minres_init",
           "block_cg_body", "block_minres_body"]


# ------------------------------------------------------------- small helpers
def _colsum(v: torch.Tensor) -> torch.Tensor:
    """Per-column squared norm, always real (matches cg._colsum)."""
    if v.is_complex():
        return torch.sum((v.conj() * v).real, dim=0)
    return torch.sum(v * v, dim=0)


def _mask_cols(v: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """Zero the converged columns of a block vector (deflation mask)."""
    return torch.where(done[None, :], torch.zeros((), dtype=v.dtype,
                                                  device=v.device), v)


def _gram(V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``VᴴW`` through the Kahan-compensated tall-skinny kernel."""
    return ops.tsmttsm(V, W, kahan=True)


def _diag_real(G: torch.Tensor) -> torch.Tensor:
    d = torch.diagonal(G)
    return d.real if d.is_complex() else d


def _herm(G: torch.Tensor) -> torch.Tensor:
    return 0.5 * (G + G.conj().T)


def _eigh_pinv_apply(G, B, *, rel_eps):
    """``G⁺ B`` with eigenvalues below ``rel_eps * λ_max`` clipped to a
    zero inverse — rank-deficient directions receive zero weight."""
    w, U, _ = ops.herm_eig(_herm(G))
    wmax = torch.clamp_min(torch.max(torch.abs(w)), torch.finfo(w.dtype).tiny)
    inv = torch.where(w > rel_eps * wmax,
                      1.0 / torch.where(w == 0, 1.0, w), 0.0)
    return U @ (inv[:, None].to(U.dtype) * (U.conj().T @ B))


def _spd_solve(G, B):
    """Solve ``G X = B`` for Hermitian positive semidefinite ``G``.

    Cholesky first; if it fails (``info > 0``) or its solve is not
    finite, a clipped eigh pseudo-inverse takes over.  Both branches are
    computed and ``torch.where`` selects, so nothing waits on the host.
    """
    L, info = torch.linalg.cholesky_ex(G)
    sol_c = torch.cholesky_solve(B, L)
    ok = (info == 0) & torch.all(torch.isfinite(sol_c))
    m = G.shape[0]
    rel_eps = torch.finfo(_diag_real(G).dtype).eps * m
    sol_e = _eigh_pinv_apply(G, B, rel_eps=rel_eps)
    return torch.where(ok, sol_c, sol_e)


def _svqb(W, *, rel_eps):
    """SVQB orthonormalization: ``W = V B`` with ``VᴴV ≈ I``.

    Gram through the compensated tsmttsm kernel, eigendecomposition of
    the scaled Gram, basis update through tsmm.  Eigenvalues below
    ``rel_eps * λ_max`` are clipped: those directions are deflated (zero
    columns in ``V``, zero rows in ``B``).  A zero ``W`` yields ``V = 0``,
    ``B = 0`` (happy breakdown).
    """
    T, B = svqb_factors(_gram(W, W), rel_eps=rel_eps)
    return ops.tsmm(W, T), B                      # orthonormal basis, W ≈ V B


def svqb_factors(G, *, rel_eps):
    """The ``(m, m)`` algebra of :func:`_svqb` on the Gram ``G = WᴴW``:
    the basis transform ``T`` (``V = W T``) and ``B`` (``W ≈ V B``)."""
    d = _diag_real(G)
    ds = torch.where(d <= 0, 1.0, d) ** -0.5      # Jacobi scaling
    dsc = ds.to(G.dtype)
    Gs = _herm(dsc[:, None] * G * dsc[None, :])
    w, U, _ = ops.herm_eig(Gs)
    wmax = torch.max(torch.abs(w))
    keep = w > rel_eps * torch.clamp_min(wmax, torch.finfo(w.dtype).tiny)
    inv_sqrt = torch.where(keep, torch.where(w == 0, 1.0, w) ** -0.5, 0.0)
    sqrt_w = torch.where(keep, torch.sqrt(torch.abs(w)), 0.0)
    T = (dsc[:, None] * U) * inv_sqrt[None, :].to(G.dtype)
    B = (sqrt_w[:, None].to(G.dtype) * U.conj().T
         * (1.0 / dsc)[None, :])
    return T, B


def _rel_eps(dtype: torch.dtype, m: int) -> float:
    real = torch.empty((), dtype=dtype).real.dtype
    return float(torch.finfo(real).eps) * m


def _eye(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=like.dtype, device=like.device)


# ------------------------------------------------------------------ block CG
class BlockCGState(NamedTuple):
    """Resumable block-CG state (one shared Krylov space per block).

    BCGrQ: the residual block is carried in factored form ``R_k = V_k C_k``
    with ``V_k`` SVQB-orthonormal and ``C_k`` a cumulative ``(b, b)``
    coefficient.  ``x``/``rr``/``it``/``done`` line up with
    :class:`repro_torch.solvers.cg.CGState` so ``cg_finalize`` works
    unchanged.
    """

    x: torch.Tensor           # (n, b) iterate
    v: torch.Tensor           # (n, b) orthonormal residual basis V_k
    p: torch.Tensor           # (n, b) scaled search-direction block P~_k
    cmat: torch.Tensor        # (b, b) cumulative coefficient C_k (R = V C)
    rr: torch.Tensor          # (b,)   true ||r||^2 (real)
    tol2: torch.Tensor        # (b,)   per-column squared abs tolerance
    it: int                   # block iteration counter
    maxiter: int              # block iteration cap
    done: torch.Tensor        # (b,)   per-column convergence flag


# block states must never be column-spliced: the (b, b) carries couple
# every column (see merge_columns_masked's guard)
BlockCGState.BLOCK_COUPLED = True


def _tol2_floored(tol, b2: torch.Tensor) -> torch.Tensor:
    """Squared relative tolerance with the zero-rhs floor."""
    tiny = torch.finfo(b2.dtype).tiny
    bnorm2 = torch.clamp_min(_colsum(b2), tiny)
    t = torch.as_tensor(tol, dtype=bnorm2.dtype,
                        device=bnorm2.device).broadcast_to(bnorm2.shape)
    return torch.clamp_min((t * t) * bnorm2, tiny)


def _start_block(op, b, x0):
    """2-d views; zero-rhs columns are solved by ``x = 0`` on the spot."""
    b2, _ = as2d(b)
    x = torch.zeros_like(b2) if x0 is None else as2d(
        torch.as_tensor(x0, device=b2.device))[0]
    x = _mask_cols(x, _colsum(b2) <= 0)
    return b2, x, b2 - op.mv(x)


def block_cg_init(op, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
                  tol=1e-8, maxiter: int = 500) -> BlockCGState:
    """Initial block-CG state (op SPD; all columns share one Krylov space).
    ``tol`` may be a scalar or per-column ``(b,)``."""
    b2, x, r = _start_block(op, b, x0)
    tol2 = _tol2_floored(tol, b2)
    V, C = _svqb(r, rel_eps=_rel_eps(r.dtype, b2.shape[1]))
    rr = _colsum(C)                                # ||R e_j||^2 = ||C e_j||^2
    return BlockCGState(x=x, v=V, p=V, cmat=C, rr=rr, tol2=tol2, it=0,
                        maxiter=int(maxiter), done=rr <= tol2)


def block_cg_body(op, st: BlockCGState) -> BlockCGState:
    """One BCGrQ iteration: one block SpMV, two compensated Grams (step
    Gram + SVQB), three tall-skinny updates with an output operand and
    one without (SVQB's basis), one ``(b, b)`` SPD solve."""
    dn = st.done
    m = st.cmat.shape[0]
    rel = _rel_eps(st.v.dtype, m)
    T = op.mv(st.p)                                # one sweep for the block
    G = _herm(_gram(st.p, T))                      # P~ᴴAP~
    gamma = _spd_solve(G, _eye(m, G))
    upd = _mask_cols(gamma @ st.cmat, dn)          # γ C — per-column steps
    x = ops.tsmm(st.p, upd, st.x, 1.0, 1.0)        # X += P~ (γ C)
    W = ops.tsmm(T, gamma, st.v, -1.0, 1.0)        # V − (AP~) γ
    Vn, rho = _svqb(W, rel_eps=rel)
    cn = rho @ st.cmat                             # C_{k+1} = ρ C_k
    rr_new = torch.where(dn, st.rr, _colsum(cn).to(st.rr.dtype))
    p = ops.tsmm(st.p, rho.conj().T, Vn, 1.0, 1.0)  # P~' = V' + P~ ρᴴ
    return BlockCGState(x=x, v=Vn, p=p, cmat=cn, rr=rr_new, tol2=st.tol2,
                        it=st.it + 1, maxiter=st.maxiter,
                        done=dn | (rr_new <= st.tol2))


# -------------------------------------------------------------- block MINRES
class BlockMinresState(NamedTuple):
    """Resumable block-MINRES state (block Lanczos + incremental band QR).

    The scalar Givens cosines/sines of column MINRES become carried
    ``(b, b)`` blocks of the last two orthogonal reflections
    (``ta``..``td``, ``tb_old``, ``td_old``), the rotated rhs becomes the
    ``(b, b)`` carry ``h``, and the per-column residual estimate is the
    column norm of the rejected part.  ``x``/``resn``/``it``/``done`` line
    up with :class:`repro_torch.solvers.minres.MinresState`.
    """

    x: torch.Tensor           # (n, b) iterate
    v: torch.Tensor           # (n, b) current Lanczos block V_j
    v_old: torch.Tensor       # (n, b) V_{j-1}
    w: torch.Tensor           # (n, b) update-direction block W_j
    w_old: torch.Tensor       # (n, b) W_{j-1}
    cmat: torch.Tensor        # (b, b) subdiagonal block C_{j-1}
    ta: torch.Tensor          # (b, b) reflection blocks of step j-1 ...
    tb: torch.Tensor
    tc: torch.Tensor
    td: torch.Tensor
    tb_old: torch.Tensor      # (b, b) ... and of step j-2
    td_old: torch.Tensor
    h: torch.Tensor           # (b, b) rotated rhs carry
    resn: torch.Tensor        # (b,)   residual-norm estimate
    tolb: torch.Tensor        # (b,)   per-column absolute tolerance
    it: int
    maxiter: int
    done: torch.Tensor        # (b,)


BlockMinresState.BLOCK_COUPLED = True


def block_minres_init(op, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
                      *, tol=1e-8, maxiter: int = 500) -> BlockMinresState:
    """Initial block-MINRES state (op symmetric, possibly indefinite).
    ``tol`` may be a scalar or per-column ``(b,)``."""
    b2, x, r = _start_block(op, b, x0)
    m = b2.shape[1]
    tiny = torch.finfo(b2.dtype).tiny
    bnorm = torch.sqrt(torch.clamp_min(_colsum(b2), tiny))
    tolb = torch.clamp_min(
        torch.as_tensor(tol, dtype=bnorm.dtype,
                        device=bnorm.device).broadcast_to(bnorm.shape)
        * bnorm, tiny)
    V1, B0 = _svqb(r, rel_eps=_rel_eps(r.dtype, m))
    resn = torch.sqrt(_colsum(B0))                 # true ||r_j|| column-wise
    zeros = torch.zeros_like(b2)
    eye = _eye(m, B0)
    zb = torch.zeros_like(eye)
    return BlockMinresState(
        x=x, v=V1, v_old=zeros, w=zeros, w_old=zeros,
        cmat=zb, ta=eye, tb=zb, tc=zb, td=eye, tb_old=zb, td_old=eye,
        h=B0, resn=resn, tolb=tolb, it=0, maxiter=int(maxiter),
        done=resn <= tolb)


def block_minres_body(op, st: BlockMinresState) -> BlockMinresState:
    """One block-MINRES iteration: block Lanczos step (SVQB-orthonormal
    candidate), the new block column of T pushed through the two carried
    reflections, one fresh ``2b×2b`` reflection from a complete QR, and
    the tall-skinny update of the direction block and iterate."""
    m = st.h.shape[0]
    rel = _rel_eps(st.v.dtype, m)
    Q = op.mv(st.v)                                # one sweep for the block
    Aj = _herm(_gram(st.v, Q))                     # diagonal block T_jj
    U = (Q - ops.tsmm(st.v, Aj)
         - ops.tsmm(st.v_old, st.cmat.conj().T))
    # local reorthogonalization (second classical Gram-Schmidt pass
    # against the two in-band blocks); the V_j correction folds into the
    # diagonal block to keep T consistent
    Ac = _gram(st.v, U)
    U = U - ops.tsmm(st.v, Ac)
    Aj = _herm(Aj + Ac)
    U = U - ops.tsmm(st.v_old, _gram(st.v_old, U))
    Vn, Cj = _svqb(U, rel_eps=rel)                 # U = V_{j+1} C_j

    # band column j of T through the two carried reflections
    CprevH = st.cmat.conj().T
    tmp = st.td_old @ CprevH
    R3 = st.tb_old @ CprevH
    R2 = st.ta @ tmp + st.tb @ Aj
    d = st.tc @ tmp + st.td @ Aj
    # fresh reflection annihilating C_j under d (block Givens)
    Qc, Rfull = torch.linalg.qr(torch.cat([d, Cj], dim=0), mode="complete")
    R1 = Rfull[:m]
    QH = Qc.conj().T
    ta_n, tb_n = QH[:m, :m], QH[:m, m:]
    tc_n, td_n = QH[m:, :m], QH[m:, m:]
    h_keep = ta_n @ st.h
    h_next = tc_n @ st.h

    # W_j = (V_j - W_{j-1} R2 - W_{j-2} R3) R1^{-1}; a rank-deficient R1
    # gets unit diagonal stand-ins, whose h_keep weight is zero
    dg = _diag_real(R1)
    good = torch.abs(dg) > rel * torch.clamp_min(torch.max(torch.abs(dg)),
                                                 torch.finfo(dg.dtype).tiny)
    R1s = R1 + torch.diag(torch.where(good, 0.0, 1.0).to(R1.dtype))
    R1inv = torch.linalg.solve_triangular(R1s, _eye(m, R1), upper=True)
    R1inv = torch.where(good[:, None] & good[None, :], R1inv,
                        torch.zeros((), dtype=R1inv.dtype,
                                    device=R1inv.device))
    cand = st.v - ops.tsmm(st.w, R2) - ops.tsmm(st.w_old, R3)
    Wn = ops.tsmm(cand, R1inv)

    upd = _mask_cols(h_keep, st.done)
    x = ops.tsmm(Wn, upd, st.x, 1.0, 1.0)          # X += W_j (kept rhs part)
    resn_col = torch.sqrt(_colsum(h_next))
    resn = torch.where(st.done, st.resn, resn_col.to(st.resn.dtype))
    return BlockMinresState(
        x=x, v=Vn, v_old=st.v, w=Wn, w_old=st.w,
        cmat=Cj, ta=ta_n, tb=tb_n, tc=tc_n, td=td_n,
        tb_old=st.tb, td_old=st.td, h=h_next,
        resn=resn, tolb=st.tolb, it=st.it + 1, maxiter=st.maxiter,
        done=st.done | (resn <= st.tolb))
