"""Linear operator abstraction for the solvers.

``GhostOperator`` wraps a SELL-C-sigma matrix and exposes the fused
augmented SpM(M)V; ``MatrixFreeOperator`` is the paper's function-pointer
hook (section 5.1: "a user can replace this function pointer by a custom
function that performs the SpMV in any (possibly matrix-free) way").
The distributed operator of the JAX package is later work.

All solver vectors live in the operator's *permuted* space with shape
``(n, b)`` (block vectors); use :meth:`to_op_space` / :meth:`from_op_space`
at the boundaries.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.sellcs import SellCS
from repro_torch.core.spmv import SpmvOpts, as2d, fused_dots, spmv

__all__ = ["GhostOperator", "MatrixFreeOperator", "make_operator"]


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
    """Matrix-free SpMV hook (paper section 5.1)."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], n: int,
                 dtype: torch.dtype):
        self.fn = fn
        self.n = n
        self.dtype = dtype

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


def make_operator(A, **kw):
    if isinstance(A, SellCS):
        return GhostOperator(A, **kw)
    raise TypeError(f"cannot wrap {type(A)}")
