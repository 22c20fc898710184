"""Weight-proportional work splitting with online rebalance (GHOST 4.1).

The port of ``repro.runtime.split``.  ``plan_split`` turns per-device
weights (usually from
:meth:`repro_torch.runtime.devicepool.DevicePool.device_weights`) into
contiguous, C-aligned, non-empty row ranges via the apportionment
partitions of :mod:`repro_torch.core.partition`.  ``SplitPlan.rebalance``
performs ONE hill-climb step
(:func:`repro_torch.launch.hillclimb.proportional_step`) on the
weights given measured per-shard SpMV times — call it once per solver
outer-iteration and the split converges to equal per-shard time, which is
GHOST's bandwidth-weighted ideal discovered online instead of assumed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import partition as part
from repro_torch.launch.hillclimb import proportional_step

__all__ = ["SplitPlan", "plan_split"]


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """A concrete assignment of row blocks to pool devices."""

    nrows: int
    weights: Tuple[float, ...]            # per-shard, sum == 1
    ranges: Tuple[Tuple[int, int], ...]   # contiguous [start, end) per shard
    align: int                            # boundary alignment (SELL C)
    by_nnz: bool                          # nnz- vs row-proportional
    rowlen: Optional[np.ndarray] = None   # kept for nnz-aware re-splits
    generation: int = 0                   # rebalance steps taken so far

    # ------------------------------------------------------------ queries
    @property
    def nshards(self) -> int:
        return len(self.ranges)

    @property
    def sizes(self) -> np.ndarray:
        return np.array([e - s for (s, e) in self.ranges], np.int64)

    def shard_nnz(self) -> np.ndarray:
        if self.rowlen is None:
            raise ValueError("plan was built without rowlen")
        return np.array([int(self.rowlen[s:e].sum()) for s, e in self.ranges],
                        np.int64)

    def imbalance(self, times: Sequence[float]) -> float:
        """max/mean of per-shard times — 1.0 is a perfect split."""
        t = np.asarray(times, np.float64)
        return float(t.max() / t.mean())

    # ---------------------------------------------------------- rebalance
    def rebalance(self, measured_times: Sequence[float], *,
                  step: float = 0.5) -> "SplitPlan":
        """One hill-climb step toward equal per-shard time.

        ``measured_times[i]`` is the observed SpMV time of shard ``i``
        under THIS plan.  Returns a new plan; the matrix must be
        redistributed to follow it (the engine does this lazily).
        """
        w = proportional_step(np.asarray(self.weights, np.float64),
                              measured_times, step=step)
        return plan_split(self.nrows, w, align=self.align,
                          rowlen=self.rowlen if self.by_nnz else None,
                          generation=self.generation + 1)


def plan_split(nrows: int, weights: Sequence[float], *, align: int = 1,
               rowlen: Optional[np.ndarray] = None,
               generation: int = 0) -> SplitPlan:
    """Build a :class:`SplitPlan`.

    ``rowlen`` (per-row nonzero counts) switches to the paper's
    nnz-proportional criterion; otherwise rows are apportioned directly.
    """
    w = np.asarray(weights, np.float64)
    if (w <= 0).any():
        raise ValueError("weights must be positive")
    w = w / w.sum()
    if rowlen is not None:
        rowlen = np.asarray(rowlen)
        ranges: List[Tuple[int, int]] = part.apportioned_nnz_partition(
            rowlen, w, align=align)
    else:
        ranges = part.apportioned_row_partition(nrows, w, align=align)
    return SplitPlan(nrows=nrows, weights=tuple(float(x) for x in w),
                     ranges=tuple(ranges), align=align,
                     by_nnz=rowlen is not None, rowlen=rowlen,
                     generation=generation)
