"""The port's runtime (``repro.runtime``): GHOST's heterogeneous
execution (sections 4.1-4.2) and a serving frontend.

* :mod:`~repro_torch.runtime.devicepool` — classify torch devices (the
  card by name, the host as ``"cpu"``) into weighted classes with
  roofline-derived SpMV throughput estimates;
* :mod:`~repro_torch.runtime.split` — weight-proportional, C-aligned
  row-block splitting with a measured-time rebalance step;
* :mod:`~repro_torch.runtime.pipeline` / :mod:`~repro_torch.runtime.engine`
  — the overlapped halo pipeline on CUDA streams and events, with
  double-buffered staging, wrapped in :class:`HeterogeneousEngine` so the
  solvers run on a distributed operator unchanged; one torch device per
  shard, the card's shards through kernel B1, the host's through the
  plain version;
* :mod:`~repro_torch.runtime.service` — :class:`SolverService`, a
  continuous-batching solve frontend (queued requests coalesced into
  block solves, converged columns retired and refilled between stepper
  chunks), over a :class:`MatrixRegistry` that caches the per-matrix
  setup (SELL-C-sigma build or engine, operator, preconditioners,
  spectral bounds).
"""
from repro_torch.runtime.devicepool import DeviceClass, DevicePool
from repro_torch.runtime.split import SplitPlan, plan_split
from repro_torch.runtime.engine import HeterogeneousEngine
from repro_torch.runtime.service import (SOLVERS, TERMINAL_STATES,
                                         MatrixRegistry, ServiceResult,
                                         SolverService, SolveTicket)

__all__ = ["DeviceClass", "DevicePool", "SplitPlan", "plan_split",
           "HeterogeneousEngine", "MatrixRegistry", "SolverService",
           "SolveTicket", "ServiceResult", "SOLVERS", "TERMINAL_STATES"]
