"""The serving runtime: :class:`SolverService`, a continuous-batching
solve frontend (queued requests coalesced into block solves, converged
columns retired and refilled between stepper chunks), over a
:class:`MatrixRegistry` that caches the per-matrix setup (SELL-C-sigma
build, operator, preconditioners, spectral bounds).

The JAX package's heterogeneous engine (``DevicePool``, ``SplitPlan``,
``HeterogeneousEngine``) is not ported yet.
"""
from repro_torch.runtime.service import (SOLVERS, TERMINAL_STATES,
                                         MatrixRegistry, ServiceResult,
                                         SolverService, SolveTicket)

__all__ = ["MatrixRegistry", "SolverService", "SolveTicket", "ServiceResult",
           "SOLVERS", "TERMINAL_STATES"]
