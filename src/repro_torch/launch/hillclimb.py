"""The weight-update rule of the heterogeneous engine's rebalance loop.

The port keeps only ``proportional_step`` of ``repro.launch.hillclimb``;
the rest of that module drives the JAX package's dry-run variants.
"""
from __future__ import annotations

import numpy as np

__all__ = ["proportional_step"]


def proportional_step(weights, costs, *, step: float = 0.5,
                      floor: float = 1e-3):
    """One multiplicative hill-climb step on a weight vector.

    ``costs[i]`` is the measured (or modeled) per-shard time under the
    current ``weights``.  A shard slower than the mean is overloaded for
    its device, so its weight shrinks by ``(mean/cost)^step``; a faster
    shard grows.  ``step=1`` jumps straight to the perfectly-balanced
    weights *if* time were exactly proportional to assigned work; smaller
    steps damp measurement noise.  The fixed point is equal per-shard time
    — GHOST's bandwidth-weighted ideal (section 4.1) discovered online.

    Used by ``repro_torch.runtime.split.SplitPlan.rebalance`` (one step per
    solver outer-iteration) and reusable for any weight-tuning loop.
    Returns weights with the input sum preserved, floored at ``floor``
    of the total (capped at the equal share so the floor is always
    feasible) so no shard starves irrecoverably.

    A zero cost means the shard did no work (e.g. it holds no rows), so
    it carries no signal about its device: such entries keep their
    weight instead of exploding toward infinite speed.
    """
    w = np.asarray(weights, np.float64)
    t = np.asarray(costs, np.float64)
    if w.shape != t.shape or (w <= 0).any() or (t < 0).any():
        raise ValueError("weights/costs must be matching vectors, "
                         "weights positive, costs non-negative")
    total = w.sum()
    pos = t > 0
    if not pos.any():
        return w.copy()
    factor = np.ones_like(w)
    factor[pos] = (t[pos].mean() / t[pos]) ** step
    base = w * factor
    base = base / base.sum() * total

    # water-filling floor: pin every entry that lands below the floor and
    # rescale the rest, repeating because the rescale can push further
    # entries under — terminates in <= len(w) rounds
    lo = min(floor, 1.0 / len(w)) * total
    clipped = np.zeros(len(base), bool)
    while True:
        if clipped.all():
            return np.full_like(w, total / len(w))
        excess = total - lo * clipped.sum()
        scaled = np.where(clipped, lo,
                          base * excess / base[~clipped].sum())
        newly = (~clipped) & (scaled < lo)
        if not newly.any():
            return scaled
        clipped |= newly
