"""Roofline aggregation: reads the dry-run JSONs and renders one table
row per arch x shape x mesh, with the measured period's columns where a
JSON has them (``dryrun --measure``).

    python -m repro_torch.launch.roofline [--mesh single] [--csv]

The port of ``repro/launch/roofline.py``; it reads
``experiments/dryrun_torch/``.  ``mem/dev`` is the argument bytes a
device holds (the port has no compiled temporaries to add); ``ms``,
``peak GB``, ``compute`` and ``measured`` are the measured period's
median time, peak memory, ``compute_fraction`` and ``measured_fraction``
on the card named in its JSON.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.launch import dryrun as DR

__all__ = ["load", "fmt_s", "table", "main"]


def load(mesh: str = None) -> List[Dict]:
    rows = []
    for p in sorted(glob.glob(os.path.join(DR.OUT_DIR, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if mesh is None or r.get("mesh") == mesh:
            rows.append(r)
    return rows


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def _measured_cols(m) -> List[str]:
    if m is None:
        return ["", "", "", ""]
    if "ms" not in m:
        return ["does not fit" if m.get("fits") is False
                else "not measured", "", "", ""]
    return [f"{m['ms']:.2f}", f"{m['peak_bytes'] / 1e9:.2f}",
            f"{m['compute_fraction']:.4f}", f"{m['measured_fraction']:.4f}"]


def table(rows: List[Dict], *, md: bool = True) -> str:
    hdr = ["arch", "shape", "mesh", "t_comp", "t_mem", "t_coll",
           "bottleneck", "useful", "roofline", "mem/dev(GB)", "ms",
           "peak GB", "compute", "measured"]
    lines = []
    if md:
        lines.append("| " + " | ".join(hdr) + " |")
        lines.append("|" + "---|" * len(hdr))
    for r in rows:
        mem = r.get("memory") or {}
        total_mem = sum(mem.get(k, 0) for k in
                        ("argument_size_in_bytes", "temp_size_in_bytes",
                         "output_size_in_bytes"))
        row = [r["arch"], r["shape"], r["mesh"],
               fmt_s(r["t_compute"]), fmt_s(r["t_memory"]),
               fmt_s(r["t_collective"]), r["bottleneck"],
               f"{r.get('useful_flops_ratio', 0):.2f}",
               f"{r.get('roofline_fraction', 0):.3f}",
               f"{total_mem / 1e9:.1f}"] + _measured_cols(r.get("measured"))
        if md:
            lines.append("| " + " | ".join(row) + " |")
        else:
            lines.append(",".join(row))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    rows = load(args.mesh)
    print(table(rows, md=not args.csv))


if __name__ == "__main__":
    main()
