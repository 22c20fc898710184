"""SpMV roofline terms (GHOST sections 2 and 4.1).

The port keeps only the SpMV part of ``repro.launch.costmodel``
(``Cost``, ``spmv_code_balance``, ``spmv_cost``): the rest of that module
is the language models' cost model, which imports the JAX package's
configs and models and waits for their port.

These feed :class:`repro_torch.runtime.devicepool.DevicePool`: the
heterogeneous engine weights each device class by its *attainable SpMV
throughput*, which for a bandwidth-bound kernel is  bw / code_balance.
The paper's reference point: double precision values + 32-bit indices
give the minimum code balance of (8 + 4) / 2 = 6 bytes/flop, hence the
predicted aggregate 350/6 = 58 Gflop/s for the full CPU+GPU+PHI node
(Table 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["Cost", "spmv_code_balance", "spmv_cost"]


@dataclasses.dataclass
class Cost:
    flops: float = 0.0            # per device
    hbm_bytes: float = 0.0        # per device
    coll_bytes: float = 0.0       # per device (interconnect bytes)
    detail: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, key, flops=0.0, hbm=0.0, coll=0.0):
        self.flops += flops
        self.hbm_bytes += hbm
        self.coll_bytes += coll
        self.detail[key] = self.detail.get(key, 0.0) + flops


def spmv_code_balance(*, val_bytes: int = 8, idx_bytes: int = 4,
                      nvecs: int = 1, nnzr: float = float("inf"),
                      rhs_reload: float = 0.0) -> float:
    """Bytes of memory traffic per flop of a SELL-C-sigma SpM(M)V.

    Per nonzero and right-hand-side column: matrix value + column index are
    streamed once (amortized over ``nvecs`` block-vector columns), the
    output row is written (and read for beta-accumulation) once per row —
    i.e. ``2 * val_bytes / nnzr`` per nonzero — and ``rhs_reload`` accounts
    for x-gather traffic beyond the first load (0 = perfect cache
    residency, 1 = every gather misses).  Flops per nonzero per column: 2.
    """
    mat = (val_bytes + idx_bytes) / nvecs
    vec = 2.0 * val_bytes / max(nnzr, 1.0) + rhs_reload * val_bytes
    return (mat + vec) / 2.0


def spmv_cost(nnz: int, nrows: int, *, val_bytes: int = 8,
              idx_bytes: int = 4, nvecs: int = 1,
              rhs_reload: float = 0.0) -> Cost:
    """Structural roofline inputs for one SpM(M)V over ``nnz`` nonzeros."""
    c = Cost()
    nnzr = nnz / max(nrows, 1)
    cb = spmv_code_balance(val_bytes=val_bytes, idx_bytes=idx_bytes,
                           nvecs=nvecs, nnzr=nnzr, rhs_reload=rhs_reload)
    flops = 2.0 * nnz * nvecs
    c.add("spmv", flops=flops, hbm=flops * cb)
    return c
