"""Linear operator abstraction for the solvers.

``GhostOperator`` wraps a SELL-C-sigma matrix and exposes the fused
augmented SpM(M)V; ``MatrixFreeOperator`` is the paper's function-pointer
hook (section 5.1: "a user can replace this function pointer by a custom
function that performs the SpMV in any (possibly matrix-free) way");
``DistOperator`` runs the matvec on the heterogeneous execution engine
(:class:`repro_torch.runtime.engine.HeterogeneousEngine`) so the same
solvers run over shards on the cards and the host with task-mode overlap.

All solver vectors live in the operator's *permuted* space with shape
``(n, b)`` (block vectors); use :meth:`to_op_space` / :meth:`from_op_space`
at the boundaries.  For ``DistOperator`` the operator space is the
concatenation of the shards' own padded slices (``n`` is the sum of their
``nrows_pad``, where the reference stacks ``nshards * m_pad``); padding
slots are kept at zero so norms and dot products are exact.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.sellcs import SellCS
from repro_torch.core.spmv import SpmvOpts, as2d, fused_dots, spmv

__all__ = ["GhostOperator", "MatrixFreeOperator", "DistOperator",
           "make_operator"]


class GhostOperator:
    """The fused SpMV of a :class:`SellCS` matrix as a solver operator.

    ``impl=None`` runs the CUDA kernel for CUDA tensors and the plain
    version for CPU tensors; ``impl="ref"`` names the plain version.
    """

    def __init__(self, A: SellCS, *, impl: Optional[str] = None):
        self.A = A
        self.impl = impl
        self.n = A.nrows_pad
        # solver vectors live in the *compute* dtype; a narrower
        # store_dtype only changes what the kernel streams from memory
        self.dtype = A.dtype
        self.store_dtype = A.store_dtype
        self.device = A.device

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        y, _, _ = spmv(self.A, x, impl=self.impl)
        return y

    def mv_fused(self, x, y=None, z=None, opts: SpmvOpts = SpmvOpts()):
        return spmv(self.A, x, y, z, opts, impl=self.impl)

    def to_op_space(self, v):
        return self.A.permute(v)

    def from_op_space(self, v):
        return self.A.unpermute(v)


class MatrixFreeOperator:
    """Matrix-free SpMV hook (paper section 5.1).  ``device`` is where
    solvers that draw their own start vectors put them (``None``: the
    card)."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], n: int,
                 dtype: torch.dtype, device=None):
        self.fn = fn
        self.n = n
        self.dtype = dtype
        self.device = device

    def mv(self, x):
        return self.fn(x)

    def mv_fused(self, x, y=None, z=None, opts: SpmvOpts = SpmvOpts()):
        Ax = self.fn(x)
        if opts.gamma is not None:
            Ax = Ax - torch.as_tensor(opts.gamma, dtype=Ax.dtype,
                                      device=Ax.device) * x
        ynew = opts.alpha * Ax
        if y is not None:
            ynew = ynew + opts.beta * y
        znew = None
        if opts.chain_axpby:
            if z is None:
                raise ValueError(
                    "SpmvOpts requested a chained AXPBY (delta/eta set) but "
                    "no z vector was passed to mv_fused")
            delta = 0.0 if opts.delta is None else opts.delta
            eta = 0.0 if opts.eta is None else opts.eta
            znew = delta * z + eta * ynew
        dots = None
        if opts.any_dot:
            # the same float64, conjugated accumulation as spmv_ref — a
            # matrix-free swap must not change solver numerics
            dots = fused_dots(as2d(x)[0], as2d(ynew)[0], opts)
        return ynew, znew, dots

    def to_op_space(self, v):
        return v

    def from_op_space(self, v):
        return v


class DistOperator:
    """Distributed operator over a :class:`HeterogeneousEngine`.

    Solver vectors live on the engine's home device (the first card in
    shard order, or the host when every shard is there) as the
    concatenation of the shards' padded slices, where the JAX package
    keeps them sharded over the mesh.  Inputs are masked to the valid
    (non-padding) slots on entry and the matvec keeps padding at zero, so
    the solvers' dot products and norms see exactly the original operator
    embedded in a zero block.  Each matvec moves every shard's slice that
    lies off the home device there (``split``) and its result back
    (``join``): over k cards, (k - 1) / k of x out and of y back.  Build
    right-hand sides with :meth:`to_op_space`.

    Matrix state is read through the engine on every access, so the
    operator follows ``engine.rebalance()``: the mask is rebuilt for a
    new matrix object.  A rebalance changes the operator-space *layout*
    (and possibly ``n``): round-trip vectors built before it through
    ``from_op_space`` / ``to_op_space``.
    """

    def __init__(self, engine, *, overlap: bool = True,
                 impl: Optional[str] = None):
        self.engine = engine
        self.overlap = overlap
        self.impl = impl
        self._mask_cache = (None, None)     # (A object, its mask)

    # ------------------------------------------------------------ helpers
    @property
    def A(self):
        return self.engine.A

    @property
    def n(self) -> int:
        return self.A.n

    @property
    def dtype(self) -> torch.dtype:
        # compute dtype: what solver vectors and dot products use
        return self.A.dtype

    @property
    def store_dtype(self) -> torch.dtype:
        return self.A.store_dtype

    @property
    def device(self) -> torch.device:
        return self.A.home

    @property
    def _mask(self) -> torch.Tensor:
        """``(n, 1)`` validity mask (``g2l == -1`` marks padding), built
        on the host once per matrix object."""
        A = self.A
        key, mask = self._mask_cache
        if key is not A:
            host = np.concatenate([g >= 0 for g in A.g2l])[:, None]
            mask = torch.from_numpy(host).to(self.dtype).to(A.home)
            self._mask_cache = (A, mask)
        return mask

    def _apply(self, x, y, opts: SpmvOpts):
        A = self.A
        x2, was1d = as2d(x)
        x2 = x2 * self._mask
        nvecs = x2.shape[1]
        run = self.engine.make_matvec(
            overlap=self.overlap, impl=self.impl, nvecs=nvecs,
            with_y=y is not None, dot_yy=opts.dot_yy, dot_xy=opts.dot_xy,
            dot_xx=opts.dot_xx, has_gamma=opts.gamma is not None)
        ys = None
        if y is not None:
            ys = A.split(as2d(y)[0] * self._mask)
        outs, dots, _ = run(A.split(x2), ys, opts)
        out = A.join(outs)
        if was1d:
            out = out[:, 0]
        return out, dots

    # ---------------------------------------------------------- operator API
    def mv(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self._apply(x, None, SpmvOpts())
        return y

    def mv_fused(self, x, y=None, z=None, opts: SpmvOpts = SpmvOpts()):
        ynew, dots = self._apply(x, y, opts)
        znew = None
        if opts.chain_axpby:
            if z is None:
                raise ValueError("chained axpby requires z")
            delta = 0.0 if opts.delta is None else opts.delta
            eta = 0.0 if opts.eta is None else opts.eta
            znew = delta * z + eta * ynew
        return ynew, znew, dots

    def to_op_space(self, v):
        """Global original-space ``(nrows[, b])`` -> operator space on the
        home device (zeros in the padding slots)."""
        A = self.A
        v2, was1d = as2d(torch.as_tensor(v, device=A.home))
        out = v2.new_zeros((A.n, v2.shape[1]))
        out[A.pos_t] = v2
        return out[:, 0] if was1d else out

    def from_op_space(self, v):
        v2, was1d = as2d(v)
        out = v2[self.A.pos_t]
        return out[:, 0] if was1d else out


def make_operator(A, **kw):
    if isinstance(A, SellCS):
        return GhostOperator(A, **kw)
    from repro_torch.runtime.engine import HeterogeneousEngine
    if isinstance(A, HeterogeneousEngine):
        return DistOperator(A, **kw)
    raise TypeError(f"cannot wrap {type(A)}")
