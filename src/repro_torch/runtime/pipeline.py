"""Overlapped halo pipeline with double-buffered staging (GHOST 4.2, Fig. 5).

The port of ``repro.runtime.pipeline``.  GHOST hides the halo exchange
behind the local SpMV by putting the communication in a *task* that runs
concurrently with the local compute kernel.  Here that task is a CUDA
side stream on every card: :func:`repro_torch.core.distributed.spmv_shard_stages`
packs, copies and unpacks each card's halos there while kernel B1 runs
its local parts on its compute stream, the remote parts wait on that
card's "exchanged" event, and the host runs its own shards' stages
meanwhile.  A block between two cards goes card to card, on both cards'
side streams.
``overlap=False`` completes the exchange before any local stage is
enqueued — the paper's "No Overlap" baseline, where the reference puts
an optimization barrier.

What this module adds:

* **double-buffered halo staging**: consecutive calls take the two slots
  of a :class:`~repro_torch.core.distributed.Staging` in turn.  Under
  XLA the reference's two slots are structural; here the copies between
  card and host read pinned host memory asynchronously, so the slots are
  load-bearing: a call waits, on the events the call before last left,
  until no copy reads its slot any more.  With one slot
  (``double_buffer=False``) that wait is for the previous call's copies.
  A copy between two cards needs no such event: the streams order it
  against the pack before it and the unpack after it (see
  :class:`~repro_torch.core.distributed.Staging`);
* the reference's flags (``with_y``, the dots, ``has_gamma``), fixed
  when the callable is built; the coefficients (alpha, beta, gamma) come
  with each call as a :class:`~repro_torch.core.spmv.SpmvOpts` in place
  of the reference's ``(3, b)`` operand, which only XLA's split between
  static flags and traced operands needs;
* dtype contract: the staging carries *vector* data in the compute dtype;
  the value shards stay in their storage dtype end-to-end.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.distributed import (DistSellCS, Staging,
                                          spmv_shard_stages)
from repro_torch.core.spmv import SpmvOpts

__all__ = ["make_pipeline_spmv", "init_staging"]


def init_staging(A: DistSellCS, nvecs: int, dtype) -> Staging:
    """Fresh double-buffer halo staging: two stacks on every device of
    ``A`` and a side stream on every card."""
    return Staging(A, nvecs, dtype, slots=2)


def make_pipeline_spmv(
    A: DistSellCS,
    *,
    overlap: bool = True,
    impl: Optional[str] = None,
    nvecs: int = 1,
    with_y: bool = False,
    dot_yy: bool = False,
    dot_xy: bool = False,
    dot_xx: bool = False,
    has_gamma: bool = False,
    double_buffer: bool = False,
):
    """Build the pipelined SpMV over per-shard vectors.

    Returns ``run(xs, ys=None, opts=None, staging=None, times=None)``
    mapping the per-shard slices ``xs`` (see
    :meth:`DistSellCS.distribute_vec`) to ``(y_list, dots, staging)``.
    ``opts`` carries alpha, beta and gamma (scalars or per column); its
    dot flags are the callable's, and a gamma needs ``has_gamma``.  None
    means alpha 1, beta 0.  ``impl=None`` runs kernel B1 on
    card shards and the plain version on host shards; ``"ref"`` runs the
    plain version everywhere.  With ``double_buffer`` a ``staging`` from
    :func:`init_staging` (two slots) rotates through the calls that pass
    it back; without, the callable keeps one slot of its own.  ``times``
    is passed to ``spmv_shard_stages``.
    """
    own = None if double_buffer else Staging(A, nvecs, A.dtype)

    def run(xs, ys=None, opts=None, staging=None, times=None):
        if with_y and ys is None:
            raise ValueError(
                "pipeline built with with_y=True needs ys")
        opts = SpmvOpts() if opts is None else opts
        if opts.gamma is not None and not has_gamma:
            raise ValueError("a shift needs a pipeline built with "
                             "has_gamma=True")
        if double_buffer:
            if staging is None:
                staging = init_staging(A, nvecs, A.dtype)
        else:
            staging = own
        opts = dataclasses.replace(opts, dot_yy=dot_yy, dot_xy=dot_xy,
                                   dot_xx=dot_xx)
        out, dots, staging = spmv_shard_stages(
            A, xs, overlap=overlap, impl=impl, opts=opts,
            ys=ys if with_y else None, staging=staging, times=times)
        return out, dots, (staging if double_buffer else None)

    return run
