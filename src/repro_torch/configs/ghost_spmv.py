"""The paper's own workload: a distributed fused SpMV (the CG iteration's
kernel mix) over the heterogeneous engine's shards.

The port of ``repro.configs.ghost_spmv``.  Not a ModelConfig — this drives
``core.distributed`` directly.

``C`` differs from the JAX package's 128, its TPU lane count: on the
card a chunk of C rows is one thread block of kernel B1, and C = 32 (one
warp of rows, each row's columns spread over ``launch_geometry``'s
threads) is the chunk height every full-width run of B1 on the H100 has
used so far (``chip_smoke.py``'s phases and its B1 grid); no measured
grid has shown another C to be faster.

``w_align`` differs too: the JAX package rounds every chunk's width up to
a multiple of 8 for its kernel's width tiling, but B1 takes any width, so
the port's default is 1.  Rounding up only adds padding slots that B1
streams: a remote part of ``mlgeer_like`` on 4 shards holds about 1,500
nonzeros in some 11,750 chunks, each at least one slot wide, and at 8
those chunks held 3.0 M slots.  ``smoke`` keeps the JAX package's C = 16
and w_align = 4.
"""
from __future__ import annotations

import dataclasses

__all__ = ["SpmvWorkload", "WORKLOADS"]


@dataclasses.dataclass(frozen=True)
class SpmvWorkload:
    name: str
    n: int                 # global matrix dimension
    bw: int                # band half-width (banded_random generator)
    density: float
    nvecs: int             # block-vector width
    C: int = 32            # SELL chunk height (B1's rows per thread block)
    sigma: int = 1024
    w_align: int = 1       # B1 takes any chunk width


# ML_Geer-class problem (n ~ 1.5M, ~110M nnz in the paper), parameterized
# so the partitioner sees realistic halo structure
WORKLOADS = {
    "mlgeer_like": SpmvWorkload("mlgeer_like", n=1_504_002, bw=40,
                                density=0.9, nvecs=4),
    "cage15_like": SpmvWorkload("cage15_like", n=5_154_859, bw=20,
                                density=0.5, nvecs=1),
    "smoke": SpmvWorkload("smoke", n=4_096, bw=8, density=0.5, nvecs=2,
                          C=16, sigma=64, w_align=4),
}
