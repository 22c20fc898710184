"""The hardware table of the roofline and the dry run's mesh shapes.

The port of ``repro/launch/mesh.py``.  ``HW`` keeps the JAX package's
keys, so the cost model, ``refresh_costs`` and ``roofline`` read the same
fields, with one NVIDIA H100 SXM5's values in place of a TPU's.

A mesh here is a plain ordered mapping of axis name to size: the dry
run's production meshes are only shapes on one card, so
``make_production_mesh`` and ``make_host_mesh`` have no counterpart.
:class:`Mesh` gives such a mapping the ``.shape``, ``.axis_names`` and
``.size`` that the sharding rules and the dry run read.

    single  16 x 16 devices  ("data", "model")
    multi   2 x 16 x 16      ("pod", "data", "model")
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

__all__ = ["HW", "MESHES", "Mesh", "make_mesh"]


# NVIDIA H100 SXM5 80GB, per card, for the roofline analysis
HW = {
    # NVIDIA's H100 SXM5 datasheet: 1,979 TFLOP/s bf16 with sparsity,
    # halved for dense products
    "peak_flops_bf16": 989e12,
    # measured by chip_smoke.py (phase 15d) on an NVIDIA H100 80GB HBM3 at
    # 700.00 W: the "h100" entry of runtime/devicepool.py
    "hbm_bw": 3032.3e9,
    # NVLink 4, the published 900 GB/s per card (the key keeps the JAX
    # package's name; on this card it is NVLink, not ICI)
    "ici_bw": 900e9,
    # the card's published memory, 80 GB
    "hbm_bytes": 80e9,
}

MESHES: Dict[str, Dict[str, int]] = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}


class Mesh:
    """Axis names and sizes: the part of a JAX mesh that the sharding
    rules read (``.shape[axis]``, ``.axis_names``) and the device count
    (``.size``)."""

    def __init__(self, axes: Mapping[str, int]):
        self.shape: Dict[str, int] = dict(axes)
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.size = math.prod(self.shape.values())


def make_mesh(name: str) -> Mesh:
    """The production mesh ``"single"`` (one pod) or ``"multi"`` (two)."""
    return Mesh(MESHES[name])
