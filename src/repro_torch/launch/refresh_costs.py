"""Recompute the analytic roofline terms of saved dry-run JSONs (no model
is built; the argument bytes and a ``measured`` block's times are kept
as they are, its shares recomputed).  Used when the cost model or the
``HW`` table is refined after a sweep.

    python -m repro_torch.launch.refresh_costs

The port of ``repro/launch/refresh_costs.py``: it reads and writes
``experiments/dryrun_torch/``, and takes each JSON's mesh and layout with
the port's ``causal_skip=True``, as ``dryrun.run_cell`` does.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.costmodel import analytic_cost
from repro_torch.launch.mesh import MESHES

__all__ = ["refresh", "main"]


def refresh(path: str) -> None:
    with open(path) as f:
        r = json.load(f)
    tag = os.path.basename(path).split("__")
    if len(tag) > 3:
        return                      # hillclimb variants: produced fresh
    cfg = get_config(r["arch"])
    shape = SHAPES[r["shape"]]
    n_dev = r["n_devices"]
    dp, tp = DR.mesh_dp_tp(MESHES[r["mesh"]], r["layout"])
    ac = analytic_cost(cfg, shape, n_dev, dp=dp, tp=tp,
                       causal_skip=r["causal_skip"],
                       zero1=r["layout"] == "zero1")
    r.update(DR.roofline_terms(ac, r["model_flops_global"], n_dev))
    m = r.get("measured")
    if m is not None and "B_card" in m:
        m.update(DR.measured_shares(m, cfg, shape.kind))
    with open(path, "w") as f:
        json.dump(r, f, indent=1)


def main():
    for p in sorted(glob.glob(os.path.join(DR.OUT_DIR, "*.json"))):
        try:
            refresh(p)
        except (OSError, KeyError, ValueError) as e:
            # unreadable file / missing field / malformed JSON
            print(f"skip {os.path.basename(p)}: {e}")
    print("refreshed")


if __name__ == "__main__":
    main()
