"""Device classification and roofline-weighted throughput (GHOST 4.1).

The port of ``repro.runtime.devicepool``.  GHOST assigns each process a
*weight* proportional to the device's attainable memory bandwidth,
because SpMV is bandwidth-bound at its code balance (6 bytes/flop for
double + 32-bit indices).  ``DevicePool`` reproduces that policy over
torch devices: it groups them into classes by kind (a CUDA device's
``torch.cuda.get_device_name``, ``"cpu"`` for the host), attaches
per-class bandwidth/peak-flop specs (known parts from a table, unknown
parts from a conservative default), and turns
:func:`repro_torch.launch.costmodel.spmv_cost` roofline terms into
per-device throughput estimates -> split weights.

The weights are *estimates to start from*; the engine's rebalance loop
(:meth:`repro_torch.runtime.split.SplitPlan.rebalance`) refines them
online from measured per-shard SpMV times.  The model has no transfer
term (neither package has one): a host shard's rows cross PCIe twice a
matvec, which only the measured rebalance sees.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.execution import canonical_device, resolve_device
from repro_torch.launch.costmodel import Cost, spmv_cost

__all__ = ["DeviceClass", "DevicePool", "KNOWN_DEVICE_SPECS"]


# Attainable (not peak-datasheet) numbers: mem_bw in B/s, peak_flops in
# FLOP/s.  Matching is by substring of the lower-cased kind, longest
# match wins; a detected host CPU is looked up as "host cpu".
KNOWN_DEVICE_SPECS: Dict[str, Dict[str, float]] = {
    # mem_bw: a 2 GiB float64 copy on the card, read + written bytes,
    # 3032.3 GB/s, measured by chip_smoke.py (phase 15d) on an NVIDIA H100
    # 80GB HBM3 at a 700.00 W power limit; peak_flops: the data sheet's
    # float64 rate outside the tensor cores
    "h100": dict(mem_bw=3032.3e9, peak_flops=34e12),
    # mem_bw: a 2 GiB float64 copy on the host, read + written bytes, by
    # torch's 8 threads, 44.7 GB/s, measured by chip_smoke.py (phase 15d)
    # on the host of that card: x86_64, 8 cores, its CPU model reported
    # as "unknown" there (a second run of the same copy gave 60.8 GB/s);
    # peak_flops: not measured (the default's; a host SpMV is
    # bandwidth-bound far below it)
    "host cpu": dict(mem_bw=44.7e9, peak_flops=0.5e12),
    # the paper's Table 1 reference node (Emmy: SNB socket 50 GB/s, K20
    # GPU and Xeon Phi ~150 GB/s each), for synthetic pools and unknown
    # kinds: any other CUDA card falls back to "gpu"
    "gpu":     dict(mem_bw=150e9, peak_flops=1.17e12),   # paper's K20
    "phi":     dict(mem_bw=150e9, peak_flops=1.0e12),    # paper's Xeon Phi
    "cpu":     dict(mem_bw=50e9, peak_flops=0.43e12),    # paper's SNB socket
}
_DEFAULT_SPEC = dict(mem_bw=50e9, peak_flops=0.5e12)


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """One class of identical devices inside a pool."""

    name: str                 # e.g. "NVIDIA H100 80GB HBM3", "cpu"
    count: int                # devices of this class (contiguous in pool order)
    mem_bw: float             # attainable memory bandwidth, B/s
    peak_flops: float         # peak compute, FLOP/s

    def time_for(self, cost: Cost) -> float:
        """Roofline execution-time estimate of ``cost`` on ONE device."""
        t_mem = cost.hbm_bytes / self.mem_bw
        t_cmp = cost.flops / self.peak_flops
        return max(t_mem, t_cmp)

    def spmv_throughput(self, cost: Cost) -> float:
        """Attainable flop rate on ``cost`` (bandwidth-bound for SpMV)."""
        return cost.flops / max(self.time_for(cost), 1e-30)


def _lookup_spec(kind: str, platform: str = "") -> Dict[str, float]:
    """Longest substring match on the kind, then on the platform (which
    routes an unknown CUDA card to the 'gpu' spec instead of the
    conservative default)."""
    for probe in (kind.lower(), platform.lower()):
        best = None
        for key in KNOWN_DEVICE_SPECS:
            if probe and key in probe and (best is None or
                                           len(key) > len(best)):
                best = key
        if best:
            return KNOWN_DEVICE_SPECS[best]
    return dict(_DEFAULT_SPEC)


def _kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


class DevicePool:
    """An ordered pool of devices grouped into weighted classes.

    Order matters: device ``i`` of the pool is shard ``i`` of the engine,
    so ``device_weights()`` lines up with shard ids.  ``devices`` holds
    the torch devices of a detected pool (None for a synthetic one).
    """

    def __init__(self, classes: Sequence[DeviceClass],
                 devices: Optional[Sequence[torch.device]] = None):
        if not classes:
            raise ValueError("empty device pool")
        self.classes = tuple(classes)
        self.devices = None if devices is None else tuple(devices)

    # ------------------------------------------------------------- build
    @classmethod
    def detect(cls, devices=None) -> "DevicePool":
        """Classify torch devices by kind.  ``None`` means every CUDA
        device (and raises without a card); name the host to pool it,
        e.g. ``detect(["cuda", "cpu"])``."""
        if devices is None:
            resolve_device(None)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devs = [canonical_device(d) for d in devices]
        classes: List[DeviceClass] = []
        for d in devs:
            kind = _kind(d)
            if classes and classes[-1].name == kind:
                classes[-1] = dataclasses.replace(
                    classes[-1], count=classes[-1].count + 1)
            else:
                spec = (KNOWN_DEVICE_SPECS["host cpu"] if d.type == "cpu"
                        else _lookup_spec(kind, "gpu"))
                classes.append(DeviceClass(name=kind, count=1, **spec))
        return cls(classes, devs)

    @classmethod
    def from_bandwidths(cls, bws: Sequence[float], *,
                        names: Optional[Sequence[str]] = None,
                        peak_flops: float = 1e12) -> "DevicePool":
        """Synthetic pool, one device per bandwidth entry (GB/s accepted:
        values < 1e6 are treated as GB/s).  Used by tests to reproduce the
        paper's CPU(50) + GPU(150) + PHI(150) node."""
        classes = []
        for i, bw in enumerate(bws):
            bw = float(bw) * (1e9 if bw < 1e6 else 1.0)
            name = names[i] if names else f"dev{i}"
            classes.append(DeviceClass(name=name, count=1, mem_bw=bw,
                                       peak_flops=peak_flops))
        return cls(classes)

    # ------------------------------------------------------------ queries
    @property
    def ndevices(self) -> int:
        return sum(c.count for c in self.classes)

    def device_classes(self) -> List[DeviceClass]:
        """Per-device class, expanded in pool order (len == ndevices)."""
        out: List[DeviceClass] = []
        for c in self.classes:
            out.extend([c] * c.count)
        return out

    def device_weights(self, *, nnz: int = 0, nrows: int = 0,
                       val_bytes: int = 4, idx_bytes: int = 4,
                       nvecs: int = 1) -> np.ndarray:
        """Per-device split weights ~ attainable SpMV throughput.

        With no matrix statistics this degrades to pure bandwidth
        proportionality (the paper's default).  With ``nnz``/``nrows`` the
        weight uses the full roofline (a compute-starved device class can
        cap below its bandwidth share for very wide block vectors).
        """
        if nnz and nrows:
            cost = spmv_cost(nnz, nrows, val_bytes=val_bytes,
                             idx_bytes=idx_bytes, nvecs=nvecs)
            w = [c.spmv_throughput(cost) for c in self.device_classes()]
        else:
            w = [c.mem_bw for c in self.device_classes()]
        w = np.asarray(w, np.float64)
        return w / w.sum()

    def aggregate_spmv_gflops(self, *, val_bytes: int = 8,
                              idx_bytes: int = 4, nvecs: int = 1,
                              nnzr: float = 64.0) -> float:
        """Predicted aggregate Gflop/s at the SpMV code balance — the
        paper's Table 1 prediction (sum of bw / 6 bytes-per-flop)."""
        nnz = int(nnzr * 1000)
        cost = spmv_cost(nnz, 1000, val_bytes=val_bytes,
                         idx_bytes=idx_bytes, nvecs=nvecs)
        return sum(c.spmv_throughput(cost) for c in self.device_classes()) / 1e9

    def __repr__(self) -> str:
        parts = ", ".join(f"{c.count}x{c.name}@{c.mem_bw / 1e9:.0f}GB/s"
                          for c in self.classes)
        return f"DevicePool({parts})"
