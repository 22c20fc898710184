"""Hill climbing: run one dry-run cell with named optimization
variants and log the roofline-term deltas, plus the reusable
``proportional_step`` weight-update rule.

The port of ``repro/launch/hillclimb.py``.  Importing it is side-effect
free (the heterogeneous runtime's rebalance loop pulls
``proportional_step`` from here); the dry run loads only inside
``main()``.

    python -m repro_torch.launch.hillclimb --arch qwen2_5_3b \
        --shape train_4k --variant fsdp_layout [--measure]

Variants (composable, comma-separated):
    baseline       — defaults (TP layout)
    fsdp_layout    — treat 'model' as extra FSDP/data parallelism
    zero1_layout   — params replicated, optimizer state sharded
    causal_skip    — a no-op: the port's attention always skips the tiles
                     the causal mask empties, and its dry run counts so
    chunkwise      — chunkwise-parallel mLSTM
    chunked_mamba  — the Mamba scan recomputing its terms per chunk
    dense_moe      — conventional one-hot MoE dispatch (ablation: the
                     paper's sparse dispatch OFF)
Each run writes experiments/dryrun_torch/<cell>__<variant>.json.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

__all__ = ["proportional_step", "apply_variants", "main"]


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


def apply_variants(arch: str, variants):
    """The config of ``arch`` with ``variants`` applied; sets the sharding
    layout (``tp`` unless a layout variant names another)."""
    from repro_torch.configs import get_config
    from repro_torch.models import sharding as SH
    cfg = get_config(arch)
    SH.set_layout("tp")
    for v in variants:
        if v in ("baseline", "causal_skip"):
            continue
        elif v == "fsdp_layout":
            SH.set_layout("fsdp")
        elif v == "zero1_layout":
            SH.set_layout("zero1")
        elif v == "chunkwise":
            cfg = dataclasses.replace(
                cfg, xlstm=dataclasses.replace(cfg.xlstm, chunkwise=True))
        elif v == "chunked_mamba":
            cfg = dataclasses.replace(
                cfg, ssm=dataclasses.replace(cfg.ssm, scan_impl="chunked"))
        elif v == "dense_moe":
            if cfg.moe is None:
                raise ValueError("variant 'dense_moe' needs a MoE config")
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, ghost_dispatch=False))
        else:
            raise SystemExit(f"unknown variant {v}")
    return cfg


def main(argv=None):
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import MESHES, make_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--mesh", choices=sorted(MESHES), default="single")
    ap.add_argument("--measure", action="store_true",
                    help="also run one period of the cell on the card")
    args = ap.parse_args(argv)

    variants = args.variant.split(",")
    cfg = apply_variants(args.arch, variants)
    tag = "+".join(v for v in variants if v != "baseline") or "baseline"
    r = run_cell(args.arch, args.shape, make_mesh(args.mesh), args.mesh,
                 cfg=cfg, tag=tag, measure=args.measure)
    print(f"\n== {args.arch} x {args.shape} [{tag}] ==")
    for k in ("t_compute", "t_memory", "t_collective", "bottleneck",
              "roofline_fraction", "useful_flops_ratio"):
        print(f"  {k}: {r[k]}")
    return r


if __name__ == "__main__":
    main()
