"""SLO-aware continuous-batching solver service on the stepper solvers.

The port of ``repro.runtime.service``.  GHOST's pitch (C2 + C5) is that
many independent sparse solves should be fed through one high-intensity
block-vector kernel stream with the runtime doing intelligent resource
management.  This module is that runtime for the solve workload:

* :class:`MatrixRegistry` caches the expensive per-matrix setup —
  SELL-C-sigma conversion/permutation, the solver-facing operator, the
  preconditioners, and Lanczos spectral bounds for KPM/ChebFD and
  Chebyshev requests.  Registering the same name twice is a cache hit.
  The cached bounds double as a *free difficulty signal*:
  :meth:`MatrixRegistry.predicted_iters` turns ``(kappa, tol)`` into an
  iteration-count estimate the service buckets and schedules by.

* :class:`SolverService` accepts asynchronous solve requests (matrix
  handle, right-hand side, solver kind, tolerance, optional
  preconditioner spec, optional ``deadline=`` / ``priority=``) and
  coalesces them into block solves per
  ``(matrix, solver, dtype, precond, store_dtype, block, bucket)`` key.
  Each :meth:`~SolverService.step` advances one (bucketed) or every
  (fifo) active batch by one k-iteration chunk, retires converged /
  cancelled / deadline-expired columns, and refills the freed slots from
  the queue — *continuous batching*.

On the card a registered SELL-C-sigma matrix runs every chunk through the
SpMV kernel (B1), block-Jacobi requests through the block-diagonal kernel
(B4) and ``block=True`` requests through the tall-skinny kernels (B2,
B3).  Right-hand sides and results stay host numpy arrays in original
space; only the admitted columns cross to the card at a refill and only
the retiring columns come back.

Request lifecycle (each ticket takes exactly one terminal transition)::

                 submit()
                    │  full per-key queue?
                    ├────────────────────► rejected
                    ▼
                 queued  ──cancel()──────► cancelled
                    │  deadline passed
                    │  at a refill? ─────► expired
                    ▼
                 running ──cancel()──┐ (at the next chunk boundary)
                    │                └───► cancelled
                    │  deadline passed
                    │  at retire? ───────► expired   (best-effort x)
                    ▼
                  done   (converged or maxiter-exhausted)

Typical use::

    reg = MatrixRegistry()
    reg.register("laplace", rows=r, cols=c, vals=v, shape=(n, n), C=16)
    svc = SolverService(reg, block_width=8, chunk_iters=16,
                        admission="bucketed", max_queue=256)
    t1 = svc.submit("laplace", b1, solver="cg", tol=1e-7,
                    deadline=0.5, priority=1)
    svc.drain()
    x1 = t1.result.x                 # original (unpermuted) space, numpy

``register(device="cpu")`` builds on the CPU and the service then runs
the kernels' plain versions; the default ``device=None`` is the card.
All timing flows through an injectable monotonic ``clock``.  A chunk's
time is read after its ``done`` flags reach the host, so it is the time
the card took, not the time Python took to enqueue it.

Differences from the JAX package: ``register`` takes ``impl=None`` (the
kernel on the card, the plain version on the CPU; ``"ref"`` names the
plain version) and ``device=``, and has no ``interpret=`` or
``autotune_tiles=`` (``_Entry.tuned`` is always empty); init, finalize
and merge are plain calls, not compiled ones; dtype names in batch keys
are numpy-style (``"float64"``).  An engine-backed matrix
(:class:`~repro_torch.runtime.engine.HeterogeneousEngine`) registers as
in the JAX package and runs through its ``DistOperator`` on its shards'
devices.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import math
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sellcs import SellCS, _np_dtype, _torch_dtype, from_coo
from repro_torch.solvers.cg import (cg_finalize, cg_init, cg_step,
                                    pipelined_cg_finalize, pipelined_cg_init,
                                    pipelined_cg_step)
from repro_torch.solvers.chebfd import chebfd
from repro_torch.solvers.kpm import kpm_dos_moments
from repro_torch.solvers.lanczos import lanczos, op_device, tridiag_eigh
from repro_torch.solvers.minres import (minres_finalize, minres_init,
                                        minres_step)
from repro_torch.solvers.operator import make_operator
from repro_torch.solvers.precond import make_preconditioner, parse_precond_spec
from repro_torch.solvers.stepper import merge_columns_masked, snap_chunk

__all__ = ["MatrixRegistry", "SolverService", "SolveTicket", "ServiceResult",
           "SOLVERS", "TERMINAL_STATES"]

#: solver kind -> (init, step, finalize) stepper triple
SOLVERS = {
    "cg": (cg_init, cg_step, cg_finalize),
    "pipelined_cg": (pipelined_cg_init, pipelined_cg_step,
                     pipelined_cg_finalize),
    "minres": (minres_init, minres_step, minres_finalize),
}

_BLOCK_MAXITER = np.iinfo(np.int32).max // 2   # block counter never binds

#: ticket states from which no further transition happens
TERMINAL_STATES = frozenset({"done", "cancelled", "rejected", "expired"})

#: effective condition number assumed when the Lanczos bracket includes
#: zero or negative eigenvalues (indefinite / singular-looking systems
#: give no usable kappa; predict "hard" rather than guessing)
_INDEFINITE_KAPPA = 1e8

#: Ritz values below this fraction of the spectral radius are treated as
#: float32-Lanczos ghosts and skipped when estimating the condition number
_GHOST_RITZ_FLOOR = 1e-3


def _dtype_name(dtype) -> str:
    """numpy-style name (``"float64"``, ``"bfloat16"``) of a torch, numpy
    or named dtype: the spelling the JAX package's keys use."""
    return str(_torch_dtype(dtype)).removeprefix("torch.")


# ---------------------------------------------------------------- registry
@dataclasses.dataclass
class _Entry:
    name: str
    matrix: object                    # SellCS | HeterogeneousEngine | op
    op: object                        # solver-facing operator
    nglobal: int                      # original-space rhs length
    build_seconds: float
    tuned: dict                       # always empty: the port tunes nothing
    store_dtype: str = ""             # resolved value-storage dtype name
    fingerprint: Optional[tuple] = None   # COO identity (shape/nnz/sums)
    bounds: Optional[Tuple[float, float]] = None
    ritz: Optional[np.ndarray] = None     # raw Ritz values of the one run
    preconds: dict = dataclasses.field(default_factory=dict)  # spec -> M


def _resolved_store_dtype(vals, dtype, store_dtype) -> str:
    """The storage dtype a ``from_coo(dtype=, store_dtype=)`` build ends
    up with — ``store_dtype=None`` resolves to the compute dtype, so an
    explicit ``store_dtype`` equal to the compute dtype fingerprints
    identically to the default.  float64 stays float64 (the JAX package's
    x64-on branch, which ``core/sellcs.py`` follows)."""
    if store_dtype is not None:
        return _dtype_name(store_dtype)
    return _dtype_name(dtype if dtype is not None else np.asarray(vals).dtype)


def _coo_fingerprint(rows, cols, vals, shape, store: str = "") -> tuple:
    h = hashlib.sha256()
    for a in (np.ascontiguousarray(rows), np.ascontiguousarray(cols),
              np.ascontiguousarray(vals)):
        h.update(a.tobytes())
    v = np.asarray(vals)
    # the *resolved* storage dtype is part of the matrix identity
    return (tuple(shape), int(v.size), str(v.dtype), store, h.hexdigest())


def _storage_dtype_of(matrix, op) -> str:
    """Resolved value-storage dtype name of a registered matrix/operator."""
    sd = getattr(matrix, "store_dtype", None)       # SellCS | GhostOperator
    if sd is None:
        sd = getattr(getattr(op, "A", None), "store_dtype", None)
    if sd is None:
        sd = getattr(op, "dtype", None)             # bare operator: compute
    return "" if sd is None else _dtype_name(sd)


class MatrixRegistry:
    """Cache of per-matrix setup shared across solver requests.

    The expensive work a request must *not* repay: SELL-C-sigma
    conversion and permutation vectors, operator construction, the
    preconditioners, and the short Lanczos run that brackets the spectrum
    for KPM/ChebFD/Chebyshev.  ``stats`` counts builds vs. cache hits.
    """

    def __init__(self):
        self._entries: Dict[str, _Entry] = {}
        self.stats = {"builds": 0, "hits": 0,
                      "bounds_computed": 0, "bounds_hits": 0,
                      "precond_builds": 0, "precond_hits": 0}

    # -------------------------------------------------------------- admin
    def register(self, name: str, matrix=None, *,
                 rows=None, cols=None, vals=None, shape=None,
                 C: int = 32, sigma: int = 1, w_align: int = 1, dtype=None,
                 store_dtype=None, impl: Optional[str] = None,
                 device=None) -> str:
        """Register a matrix under ``name`` (idempotent — reuse is a hit).

        ``matrix`` may be a prebuilt :class:`SellCS`, a
        :class:`~repro_torch.runtime.engine.HeterogeneousEngine` (sharded
        matrices run through ``DistOperator`` unchanged, on the engine's
        devices), or an operator implementing the full solver protocol
        (``mv``, ``mv_fused``, ``n``, ``dtype``, ``to_op_space``,
        ``from_op_space`` — e.g.
        :class:`~repro_torch.solvers.operator.MatrixFreeOperator`).
        Alternatively pass COO triplets (``rows``/``cols``/``vals``/
        ``shape``) and the SELL-C-sigma build happens here, once, on
        ``device`` (``None``: the card; raises without one).
        ``store_dtype`` narrows the stored values and is part of the
        matrix identity.  ``impl=None`` runs the SpMV kernel on the card
        and its plain version on the CPU; ``impl="ref"`` names the plain
        version.

        Re-registering a name with the *same* payload is a cache hit;
        with a different matrix (different COO bytes *or* a different
        ``store_dtype``) it raises.
        """
        if name in self._entries:
            e = self._entries[name]
            if matrix is not None:
                if matrix is not e.matrix:
                    raise ValueError(
                        f"matrix {name!r} is already registered with a "
                        f"different object; use a new name")
            elif vals is not None:
                sd = _resolved_store_dtype(vals, dtype, store_dtype)
                if _coo_fingerprint(rows, cols, vals, shape,
                                    sd) != e.fingerprint:
                    raise ValueError(
                        f"matrix {name!r} is already registered with "
                        f"different COO data or storage dtype; use a "
                        f"new name")
            self.stats["hits"] += 1
            return name
        t0 = time.perf_counter()
        fingerprint = None
        if matrix is None:
            if rows is None or cols is None or vals is None or shape is None:
                raise ValueError(
                    "register() needs either a prebuilt matrix/operator or "
                    "COO triplets rows/cols/vals plus shape")
            fingerprint = _coo_fingerprint(
                rows, cols, vals, shape,
                _resolved_store_dtype(vals, dtype, store_dtype))
            matrix = from_coo(rows, cols, vals, tuple(shape), C=C,
                              sigma=sigma, w_align=w_align, dtype=dtype,
                              store_dtype=store_dtype, device=device)
        if hasattr(matrix, "mv") and hasattr(matrix, "mv_fused"):
            missing = [a for a in ("n", "dtype", "to_op_space",
                                   "from_op_space") if not hasattr(matrix, a)]
            if missing:
                raise TypeError(
                    f"operator for {name!r} is missing {missing}; the "
                    f"service needs the full solver protocol (mv, mv_fused, "
                    f"n, dtype, to_op_space, from_op_space)")
            op = matrix                               # already an operator
        else:
            op = make_operator(matrix, impl=impl)
        # original-space rhs length: the matrix knows it; a bare operator
        # falls back to its wrapped matrix, then to op.n
        nglobal = getattr(matrix, "nrows", None)
        if nglobal is None:
            nglobal = getattr(getattr(op, "A", None), "nrows", None) or op.n
        self._entries[name] = _Entry(
            name=name, matrix=matrix, op=op, nglobal=int(nglobal),
            build_seconds=time.perf_counter() - t0, tuned={},
            store_dtype=_storage_dtype_of(matrix, op),
            fingerprint=fingerprint)
        self.stats["builds"] += 1
        return name

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> List[str]:
        return list(self._entries)

    # ------------------------------------------------------------- lookups
    def entry(self, name: str) -> _Entry:
        e = self._entries.get(name)
        if e is None:
            raise KeyError(f"matrix {name!r} is not registered "
                           f"(have: {sorted(self._entries)})")
        return e

    def operator(self, name: str):
        return self.entry(name).op

    def tuned(self, name: str) -> dict:
        return dict(self.entry(name).tuned)

    def _lanczos_ritz(self, name: str, *, k: int = 30,
                      seed: int = 0) -> np.ndarray:
        """The cached raw Ritz values of ONE short Lanczos run per matrix
        — :meth:`spectral_bounds` widens their extremes,
        :meth:`predicted_iters` reads a condition number off them.  The
        start vector comes from a ``torch.Generator`` seeded with
        ``seed``, not from the JAX package's ``jax.random``."""
        e = self.entry(name)
        if e.ritz is None:
            res = lanczos(e.op, None, k, seed=seed)
            nv = max(int(res.nvalid), 1)
            ev, _ = tridiag_eigh(res.alphas[:nv], res.betas[:max(nv - 1, 0)])
            e.ritz = np.asarray(ev, np.float64)
            self.stats["bounds_computed"] += 1
        else:
            self.stats["bounds_hits"] += 1
        return e.ritz

    def spectral_bounds(self, name: str, *, k: int = 30, seed: int = 0,
                        safety: float = 1.05) -> Tuple[float, float]:
        """Cached Lanczos (lambda_min, lambda_max) bracket for KPM/ChebFD,
        widened as :func:`repro_torch.solvers.lanczos.lanczos_extrema`
        widens it; the Ritz values are shared with
        :meth:`predicted_iters`."""
        e = self.entry(name)
        if e.bounds is None:
            ritz = self._lanczos_ritz(name, k=k, seed=seed)
            lo, hi = float(ritz[0]), float(ritz[-1])
            mid, rad = (hi + lo) / 2, (hi - lo) / 2
            rad = max(rad * safety, 1e-12)
            e.bounds = (mid - rad, mid + rad)
        else:
            self.stats["bounds_hits"] += 1
        return e.bounds

    def predicted_iters(self, name: str, *, solver: str = "cg",
                        tol: float = 1e-8,
                        maxiter: Optional[int] = None) -> int:
        """Predicted Krylov iteration count — the free difficulty signal.

        The classic CG bound on the registry-cached Ritz values: about
        ``sqrt(kappa)/2 * ln(2/tol)`` iterations, every solver kind alike.
        Ritz values below ``_GHOST_RITZ_FLOOR`` of the spectral radius are
        skipped; a spectrum with no usable positive part predicts *hard*
        (``_INDEFINITE_KAPPA``).  The service consumes only its order of
        magnitude.  Clamped to ``[1, maxiter]`` when ``maxiter`` is given.
        """
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r} "
                             f"(have: {sorted(SOLVERS)})")
        ritz = self._lanczos_ritz(name)
        if float(ritz[-1]) <= 0:          # negative-definite: flip the sign
            ritz = -ritz[::-1]
        hi = float(ritz[-1])
        genuine = ritz[ritz > hi * _GHOST_RITZ_FLOOR] if hi > 0 else ritz[:0]
        kappa = (hi / float(genuine[0])) if genuine.size \
            else _INDEFINITE_KAPPA
        kappa = max(float(kappa), 1.0)
        tol = float(tol)
        if not tol > 0:
            raise ValueError(f"tol must be > 0, got {tol!r}")
        decay = max(math.log(2.0 / tol), 1.0)
        pred = int(math.ceil(0.5 * math.sqrt(kappa) * decay))
        pred = max(pred, 1)
        if maxiter is not None:
            pred = min(pred, max(int(maxiter), 1))
        return pred

    def preconditioner(self, name: str, spec: str):
        """Cached preconditioner for matrix ``name``.

        ``spec`` is ``"block_jacobi[:<block_size>]"`` (needs a SELL-C-σ
        matrix — the blocks come straight out of its storage; on the card
        its apply is kernel B4) or ``"chebyshev[:<degree>]"`` (any
        registered operator, including engine-backed ``DistOperator``
        matrices, over the cached spectral bounds).  Same spec twice is a
        cache hit.
        """
        kind, param = parse_precond_spec(spec)         # normalize + validate
        norm = kind if param is None else f"{kind}:{param}"
        e = self.entry(name)
        M = e.preconds.get(norm)
        if M is not None:
            self.stats["precond_hits"] += 1
            return M
        if kind.startswith("block_jacobi"):
            A = e.matrix if isinstance(e.matrix, SellCS) else \
                getattr(e.op, "A", None)
            if not isinstance(A, SellCS):
                raise ValueError(
                    f"matrix {name!r} is not SELL-C-σ backed "
                    f"({type(e.matrix).__name__}); block_jacobi needs the "
                    f"stored blocks — use chebyshev for engine-backed or "
                    f"matrix-free operators")
            M = make_preconditioner(norm, matrix=A)
        else:
            M = make_preconditioner(norm, op=e.op,
                                    spectrum=self.spectral_bounds(name))
        e.preconds[norm] = M
        self.stats["precond_builds"] += 1
        return M


# ----------------------------------------------------------------- requests
class ServiceResult(NamedTuple):
    x: np.ndarray                     # solution, original (unpermuted) space
    iters: int                        # block iterations spent on this column
    resnorm: float
    converged: bool


class SolveTicket:
    """Handle for one submitted request (fills in as the service steps).

    ``status`` walks ``queued -> running -> <terminal>`` where the
    terminal states are ``done`` (result present, ``converged`` True or
    False), ``cancelled`` (no result), ``rejected`` (admission control
    refused it, no result), and ``expired`` (deadline passed — a
    best-effort result is present if the solve had started).  The
    service guarantees exactly one terminal transition per ticket.  All
    timestamps come from the service's injected monotonic clock.
    """

    def __init__(self, req_id: int, matrix: str, solver: str, b, tol: float,
                 maxiter: int, precond: Optional[str] = None, *,
                 deadline: Optional[float] = None, priority: int = 0,
                 clock: Callable[[], float] = time.perf_counter):
        self.id = req_id
        self.matrix = matrix
        self.solver = solver
        self.precond = precond
        self.b = b
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        self.priority = int(priority)
        self.submitted_at = clock()
        # relative seconds in, absolute clock time stored
        self.deadline: Optional[float] = (
            None if deadline is None else self.submitted_at + float(deadline))
        self.status = "queued"
        self.key: Optional[tuple] = None       # batch key, set at submit
        self.pred_iters: Optional[int] = None  # difficulty estimate, if any
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.result: Optional[ServiceResult] = None
        self._cancel_requested = False
        self._terminal_transitions = 0         # invariant: ends at exactly 1

    # ------------------------------------------------------------- queries
    @property
    def done(self) -> bool:
        """A result is present (converged, maxiter-exhausted, or the
        best-effort iterate of an expired-while-running request)."""
        return self.result is not None

    @property
    def resolved(self) -> bool:
        """The ticket took its terminal transition (any terminal state)."""
        return self.status in TERMINAL_STATES

    @property
    def rejected(self) -> bool:
        return self.status == "rejected"

    @property
    def cancelled(self) -> bool:
        return self.status == "cancelled"

    @property
    def expired(self) -> bool:
        return self.status == "expired"

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def queue_wait(self) -> Optional[float]:
        """Seconds spent queued before the first chunk (None while
        queued; for never-started terminals it spans submit->finish)."""
        if self.started_at is not None:
            return self.started_at - self.submitted_at
        if self.finished_at is not None:
            return self.finished_at - self.submitted_at
        return None

    # ----------------------------------------------------- service-internal
    def _finish(self, status: str, now: float) -> None:
        """Take the terminal transition (service-internal, exactly once)."""
        if status not in TERMINAL_STATES:
            raise ValueError(f"not a terminal status: {status!r}")
        if self.status in TERMINAL_STATES:
            raise RuntimeError(
                f"ticket #{self.id} already resolved as {self.status!r}; "
                f"second transition to {status!r} is a service bug")
        self.status = status
        self.finished_at = now
        self._terminal_transitions += 1

    def __repr__(self) -> str:
        pc = f" precond={self.precond}" if self.precond else ""
        dl = f" deadline={self.deadline:.3f}" if self.deadline is not None \
            else ""
        pr = f" prio={self.priority}" if self.priority else ""
        return (f"SolveTicket(#{self.id} {self.solver}@{self.matrix} "
                f"tol={self.tol:g}{pc}{dl}{pr} {self.status})")


class _AdmissionQueue:
    """Bounded priority queue for one batch key.

    Orders by ``(-priority, deadline, arrival)``.  Cancelled tickets are
    removed lazily at pop (the heap keeps the dead entry, ``live`` does
    not), so ``cancel()`` is O(1).
    """

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()
        self.live = 0                  # entries still in "queued" status

    def push(self, ticket: SolveTicket) -> None:
        dl = ticket.deadline if ticket.deadline is not None else math.inf
        heapq.heappush(self._heap,
                       (-ticket.priority, dl, next(self._seq), ticket))
        self.live += 1

    def pop(self) -> Optional[SolveTicket]:
        """Next still-queued ticket, or None (skips dead entries)."""
        while self._heap:
            ticket = heapq.heappop(self._heap)[3]
            if ticket.status != "queued":
                continue               # cancelled while queued: lazy removal
            self.live -= 1
            return ticket
        return None

    def note_removed(self) -> None:
        """A queued ticket left without pop (cancel while queued)."""
        self.live -= 1

    def __len__(self) -> int:
        return self.live

    def __bool__(self) -> bool:
        return self.live > 0


@dataclasses.dataclass
class _Batch:
    key: tuple   # (matrix, solver, dtype, precond, store_dtype, block, bkt)
    op: object
    init: object                      # (B, tols[, X0]) -> fresh state
    step: object
    finalize: object                  # state -> solver Result
    merge: object                     # (old, fresh, mask) -> state
    width: int = 0                    # column count of this batch's state
    M: object = None                  # preconditioner (None = plain)
    state: object = None
    slots: List[Optional[SolveTicket]] = dataclasses.field(
        default_factory=list)
    insert_it: List[int] = dataclasses.field(default_factory=list)
    block: bool = False               # shared-Krylov block batch
    est_iter_s: Optional[float] = None   # EWMA seconds per block iteration

    @property
    def active(self) -> int:
        return sum(t is not None for t in self.slots)

    def live_tickets(self) -> List[SolveTicket]:
        return [t for t in self.slots if t is not None]


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


# ------------------------------------------------------------------ service
class SolverService:
    """Coalesce independent solve requests into continuous block solves.

    ``block_width`` caps the block-vector width of every batch;
    ``chunk_iters`` is the number of solver iterations run between
    retire/refill opportunities.

    **Admission** (``admission=``):

    * ``"fifo"`` (default) — one queue per batch key, every active batch
      advances one chunk per :meth:`step`.
    * ``"bucketed"`` — requests additionally carry a log-scale
      *difficulty bucket* (from :meth:`MatrixRegistry.predicted_iters`)
      in their batch key; :meth:`step` advances the most urgent batch
      (earliest deadline slack, then highest priority, then shortest
      predicted job), with aging so no batch starves; and batch width
      adapts to queue depth (power-of-two, capped at ``block_width``).

    ``max_queue`` bounds every per-key queue (a submit beyond it returns
    a ticket already ``rejected``).  ``clock`` is the monotonic time
    source for every timestamp, deadline and chunk-size decision (default
    ``time.perf_counter``).  ``iter_time_hint(key) -> seconds`` seeds the
    per-iteration time estimate a batch uses to shrink chunks toward
    deadlines before any chunk has been measured.
    """

    def __init__(self, registry: MatrixRegistry, *, block_width: int = 8,
                 chunk_iters: int = 16, completed_log: int = 4096,
                 admission: str = "fifo", max_queue: Optional[int] = None,
                 adaptive_width: Optional[bool] = None,
                 bucket_base: float = 8.0, starvation_limit: int = 8,
                 clock: Optional[Callable[[], float]] = None,
                 iter_time_hint: Optional[Callable[[tuple], float]] = None):
        if block_width < 1:
            raise ValueError("block_width must be >= 1")
        if chunk_iters < 1:
            raise ValueError("chunk_iters must be >= 1")
        if admission not in ("fifo", "bucketed"):
            raise ValueError(f"admission must be 'fifo' or 'bucketed', "
                             f"got {admission!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        if bucket_base <= 1.0:
            raise ValueError("bucket_base must be > 1")
        if starvation_limit < 1:
            raise ValueError("starvation_limit must be >= 1")
        self.registry = registry
        self.block_width = int(block_width)
        self.chunk_iters = int(chunk_iters)
        self.admission = admission
        self.max_queue = None if max_queue is None else int(max_queue)
        self.adaptive_width = (admission == "bucketed"
                               if adaptive_width is None
                               else bool(adaptive_width))
        self.bucket_base = float(bucket_base)
        self.starvation_limit = int(starvation_limit)
        self.clock: Callable[[], float] = (
            clock if clock is not None else time.perf_counter)
        self._iter_time_hint = iter_time_hint
        self._queues: Dict[tuple, _AdmissionQueue] = {}
        self._batches: Dict[tuple, _Batch] = {}
        self._init_cache: Dict[tuple, Callable] = {}   # key -> batch init
        self._age: Dict[tuple, int] = {}           # dispatcher aging counters
        self._ids = itertools.count()
        # recently resolved *admitted* tickets, newest last; bounded so a
        # long-lived service does not pin every rhs/solution ever served.
        # Rejected tickets were never admitted and are not logged here.
        self.completed: deque = deque(
            maxlen=completed_log if completed_log > 0 else None)
        self.stats = {"submitted": 0, "retired": 0, "converged": 0,
                      "chunks": 0, "refills": 0, "batches_opened": 0,
                      "cancelled": 0, "expired": 0, "rejected": 0,
                      "deadline_chunks": 0}

    # -------------------------------------------------------------- submit
    def submit(self, matrix: str, b, *, solver: str = "cg",
               tol: float = 1e-8, maxiter: int = 500,
               precond: Optional[str] = None,
               block: bool = False,
               deadline: Optional[float] = None,
               priority: int = 0) -> SolveTicket:
        """Enqueue one solve of ``A x = b`` (``b`` a host array in
        original space).

        Returns immediately with a :class:`SolveTicket`; the solve runs
        as the service is stepped.  If the per-key queue is full
        (``max_queue``), the returned ticket is already ``rejected``.
        ``deadline`` is a relative latency target in clock seconds;
        ``priority`` (higher = sooner) orders the queue and the bucketed
        dispatcher.  ``precond`` is a spec string (see
        :meth:`MatrixRegistry.preconditioner`) and part of the batch key.
        ``block=True`` routes the request into a block-Krylov batch
        (``cg``/``minres`` only, unpreconditioned) that warm-restarts
        whenever it refills.
        """
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r} "
                             f"(have: {sorted(SOLVERS)})")
        entry = self.registry.entry(matrix)         # validates the handle
        if block:
            if solver not in ("cg", "minres"):
                raise NotImplementedError(
                    f"block=True supports solver='cg'/'minres', "
                    f"not {solver!r}")
            if precond is not None:
                raise NotImplementedError(
                    "block=True with a preconditioner is not implemented; "
                    "drop precond= or submit with block=False")
        if precond is not None:
            if solver == "pipelined_cg":
                raise NotImplementedError(
                    "pipelined_cg does not support preconditioning; "
                    "use solver='cg' with precond=, or drop precond")
            kind, param = parse_precond_spec(precond)   # fail at submit
            precond = kind if param is None else f"{kind}:{param}"
        if deadline is not None and not float(deadline) > 0:
            raise ValueError(
                f"deadline must be a positive relative latency target in "
                f"seconds, got {deadline!r}")
        if not float(tol) > 0:
            raise ValueError(f"tol must be > 0, got {tol!r}")
        # validate the rhs here: a malformed b discovered at refill time
        # would already have dequeued (and would lose) sibling requests
        b = np.asarray(b)
        if b.ndim != 1 or b.shape[0] != entry.nglobal:
            raise ValueError(
                f"rhs for {matrix!r} must be 1-d of length {entry.nglobal} "
                f"(original space), got shape {b.shape}")
        ticket = SolveTicket(next(self._ids), matrix, solver, b, tol,
                             maxiter, precond, deadline=deadline,
                             priority=priority, clock=self.clock)
        # storage dtype, block mode and (bucketed admission only) the
        # difficulty bucket are the trailing key components
        bucket = ""
        if self.admission == "bucketed":
            pred = self.registry.predicted_iters(
                matrix, solver=solver, tol=ticket.tol,
                maxiter=ticket.maxiter)
            ticket.pred_iters = pred
            bucket = f"d{int(math.log(pred, self.bucket_base))}"
        key = (matrix, solver, _dtype_name(entry.op.dtype),
               precond or "", entry.store_dtype,
               "block" if block else "", bucket)
        ticket.key = key
        self.stats["submitted"] += 1
        queue = self._queues.setdefault(key, _AdmissionQueue())
        if self.max_queue is not None and len(queue) >= self.max_queue:
            ticket._finish("rejected", self.clock())
            self.stats["rejected"] += 1
            return ticket
        queue.push(ticket)
        return ticket

    def cancel(self, ticket: SolveTicket) -> bool:
        """Cancel a request.  Returns True iff the cancellation sticks.

        A queued ticket resolves as ``cancelled`` immediately; a running
        one is retired (without a result) at the next chunk boundary —
        cancellation wins over a convergence observed at the same
        boundary.  An already-resolved ticket returns False.
        """
        if ticket.resolved:
            return False
        if ticket.status == "queued":
            queue = self._queues.get(ticket.key)
            ticket._finish("cancelled", self.clock())
            if queue is not None:
                queue.note_removed()   # heap entry dies lazily at pop
            self.completed.append(ticket)
            self.stats["cancelled"] += 1
            return True
        ticket._cancel_requested = True        # running: chunk boundary
        return True

    @property
    def pending(self) -> int:
        """Requests submitted but not yet resolved."""
        queued = sum(len(q) for q in self._queues.values())
        running = sum(b.active for b in self._batches.values())
        return queued + running

    # --------------------------------------------------------------- steps
    def step(self) -> int:
        """Advance the service by one scheduling round; returns chunks run.

        ``admission="fifo"``: every active batch advances one chunk.
        ``admission="bucketed"``: the dispatcher picks the single most
        urgent batch and advances only it.
        """
        for key, queue in self._queues.items():
            if queue and key not in self._batches:
                self._open_batch(key)
        if not self._batches:
            return 0
        if self.admission == "fifo":
            keys = list(self._batches)
        else:
            picked = self._select_key()
            keys = [picked] if picked is not None else []
        chunks = 0
        for key in keys:
            batch = self._batches.get(key)
            if batch is None:
                continue
            done = self._run_chunk(batch)
            chunks += done is not None
            self._retire_and_refill(batch, done)
            if batch.active == 0 and not self._queues.get(key):
                del self._batches[key]
                self._age.pop(key, None)
        return chunks

    def drain(self, max_steps: int = 100_000) -> "deque":
        """Step until every submitted request has been resolved."""
        steps = 0
        while self.pending:
            if steps >= max_steps:
                raise RuntimeError(
                    f"service did not drain in {max_steps} steps "
                    f"({self.pending} requests pending)")
            self.step()
            steps += 1
        return self.completed

    # --------------------------------------------------------- dispatcher
    def _select_key(self) -> Optional[tuple]:
        """Pick the batch to advance this round (bucketed admission).

        Urgency order: smallest deadline slack first, then highest
        priority, then shortest predicted remaining work.  Any batch
        skipped for ``starvation_limit`` consecutive rounds is served
        next regardless.
        """
        keys = list(self._batches)
        if not keys:
            return None
        now = self.clock()
        starved = [k for k in keys
                   if self._age.get(k, 0) >= self.starvation_limit]
        if starved:
            pick = max(starved, key=lambda k: self._age.get(k, 0))
        else:
            def score(key):
                batch = self._batches[key]
                live = batch.live_tickets()
                block_it = batch.state.it if batch.state is not None else 0
                slack = math.inf
                prio = 0
                shortest = math.inf
                for j, t in enumerate(batch.slots):
                    if t is None:
                        continue
                    spent = block_it - batch.insert_it[j]
                    pred = t.pred_iters if t.pred_iters else t.maxiter
                    remaining = max(pred - spent, 1)
                    shortest = min(shortest, remaining)
                    prio = max(prio, t.priority)
                    if t.deadline is not None:
                        est = (remaining * batch.est_iter_s
                               if batch.est_iter_s else 0.0)
                        slack = min(slack, t.deadline - now - est)
                if not live:
                    shortest = 1.0         # empty batch with queued work
                return (slack, -prio, shortest)
            pick = min(keys, key=score)
        for k in keys:
            self._age[k] = 0 if k == pick else self._age.get(k, 0) + 1
        return pick

    # ------------------------------------------------------------ internals
    def _pick_width(self, need: int, queued: int) -> int:
        """Batch width from demand: power-of-two, >= need, <= block_width."""
        if not self.adaptive_width:
            return self.block_width
        want = max(need + queued, 1)
        return min(_pow2ceil(want), self.block_width)

    def _open_batch(self, key: tuple) -> None:
        matrix, solver, _, precond, _store, blk, _bucket = key
        blk = bool(blk)
        entry = self.registry.entry(matrix)
        init, step, fin = SOLVERS[solver]
        op = entry.op
        M = (self.registry.preconditioner(matrix, precond)
             if precond else None)
        # difficulty buckets of one (matrix, solver, ...) share one init.
        # The cached closure must not own the operator or preconditioner
        # (the registry controls their lifetime): it holds weakrefs and
        # fails loudly if the entry was evicted.
        init_key = key[:6]
        batch_init = self._init_cache.get(init_key)
        if batch_init is None:
            op_ref = weakref.ref(op)
            M_ref = weakref.ref(M) if M is not None else None

            def batch_init(B, tols, X0=None):
                o = op_ref()
                if o is None:
                    raise ReferenceError(
                        "operator evicted while its batch init was cached")
                m = M_ref() if M_ref is not None else None
                if M_ref is not None and m is None:
                    raise ReferenceError("preconditioner evicted while "
                                         "its batch init was cached")
                if blk:
                    return init(o, B, X0, tol=tols, maxiter=_BLOCK_MAXITER,
                                M=m, block=True)
                return init(o, B, tol=tols, maxiter=_BLOCK_MAXITER, M=m)

            self._init_cache[init_key] = batch_init
        width = self._pick_width(1, len(self._queues.get(key) or ()) - 1)
        batch = _Batch(key=key, op=op, init=batch_init, step=step,
                       finalize=fin, merge=merge_columns_masked, M=M,
                       block=blk, width=width,
                       slots=[None] * width, insert_it=[0] * width,
                       est_iter_s=self._cold_iter_hint(key, entry, width))
        self._batches[key] = batch
        self.stats["batches_opened"] += 1
        self._refill(batch)

    def _cold_iter_hint(self, key: tuple, entry: _Entry,
                        width: int) -> Optional[float]:
        """Seconds-per-iteration estimate before any chunk was measured.

        An explicit ``iter_time_hint`` wins; engine-backed matrices fall
        back to the engine's roofline critical path
        (:meth:`HeterogeneousEngine.modeled_iter_seconds`); otherwise
        None until the first measured chunk feeds the EWMA.
        """
        if self._iter_time_hint is not None:
            return float(self._iter_time_hint(key))
        modeled = getattr(entry.matrix, "modeled_iter_seconds", None)
        if callable(modeled):
            return float(modeled(nvecs=width))
        return None

    def _pop_live(self, queue: _AdmissionQueue,
                  now: float) -> Optional[SolveTicket]:
        """Next admissible queued ticket; expires stale ones on the way
        (the queued-side deadline gate, on the column and the block
        warm-restart path alike)."""
        while True:
            ticket = queue.pop()
            if ticket is None:
                return None
            if ticket.deadline is not None and now >= ticket.deadline:
                ticket._finish("expired", now)
                self.completed.append(ticket)
                self.stats["expired"] += 1
                continue
            return ticket

    def _upload(self, op, nrows: int, width: int, cols) -> torch.Tensor:
        """The ``(nrows, width)`` right-hand-side block in operator space:
        columns ``cols = [(j, b_j), ...]`` and zeros elsewhere.  Only the
        given columns cross to the operator's device, each as one
        contiguous copy into a row of a ``(width, nrows)`` block (an
        ``np.stack`` of the columns costs the host far more than the
        copies).  Each is cast to the compute dtype on the host, as the
        JAX package casts its host block, so the block equals a full
        upload bit for bit."""
        dev = op_device(op)
        rows = torch.zeros((width, nrows), dtype=op.dtype, device=dev)
        for j, b in cols:
            rows[j].copy_(torch.from_numpy(
                np.ascontiguousarray(b, dtype=_np_dtype(op.dtype))))
        return op.to_op_space(rows.T).contiguous()

    def _download(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor as a host array (waits for the card)."""
        return t.cpu().numpy()

    def _tols(self, op, tickets, width: int) -> torch.Tensor:
        """Per-column tolerances (1 in empty slots) in the tolerance dtype
        on the operator's device."""
        tols = torch.ones(width, dtype=op.dtype.to_real())
        for j, ticket in tickets:
            tols[j] = ticket.tol
        return tols.to(op_device(op))

    def _refill(self, batch: _Batch) -> None:
        """Pull queued requests into the batch's free column slots."""
        if batch.block:
            self._refill_block(batch)
            return
        queue = self._queues.get(batch.key)
        free = [j for j, t in enumerate(batch.slots) if t is None]
        if not queue or not free:
            return
        taken: List[Tuple[int, SolveTicket]] = []
        now = self.clock()
        for j in free:
            ticket = self._pop_live(queue, now)
            if ticket is None:
                break
            ticket.started_at = now
            ticket.status = "running"
            taken.append((j, ticket))
        if not taken:
            return
        op, w = batch.op, batch.width
        Bop = self._upload(op, taken[0][1].b.shape[0], w,
                           [(j, t.b) for j, t in taken])
        fresh = batch.init(Bop, self._tols(op, taken, w))
        if batch.state is None:
            batch.state = fresh        # empty slots: zero rhs, done at init
            block_it = 0
        else:
            mask = np.zeros(w, bool)
            mask[[j for j, _ in taken]] = True
            batch.state = batch.merge(batch.state, fresh, mask)
            block_it = batch.state.it
        for j, ticket in taken:
            batch.slots[j] = ticket
            batch.insert_it[j] = block_it
        self.stats["refills"] += 1

    def _refill_block(self, batch: _Batch) -> None:
        """Refill a block-Krylov batch with a warm restart.

        Block states carry cross-column ``(b, b)`` blocks, so columns
        cannot be spliced.  The whole batch re-inits instead: survivors
        keep their current iterate as ``x0``, newcomers start from zero,
        and empty slots get a zero rhs (done at init).  ``insert_it`` goes
        negative for survivors to keep per-ticket iteration accounting
        exact across the restart.  Survivors are repacked into the
        leading columns and the width is chosen anew from demand.
        """
        queue = self._queues.get(batch.key)
        free = [j for j, t in enumerate(batch.slots) if t is None]
        if not queue or not free:
            return
        op = batch.op
        now = self.clock()
        survivors: List[Tuple[int, SolveTicket, int]] = []  # (old_j, t, spent)
        if batch.state is not None:
            block_it = batch.state.it
            for j, t in enumerate(batch.slots):
                if t is not None:
                    survivors.append((j, t, block_it - batch.insert_it[j]))
        newcomers: List[SolveTicket] = []
        while len(survivors) + len(newcomers) < self.block_width:
            ticket = self._pop_live(queue, now)
            if ticket is None:
                break
            ticket.started_at = now
            ticket.status = "running"
            newcomers.append(ticket)
        if not newcomers:
            return          # nothing admitted (stale queue): keep iterating
        m = len(survivors) + len(newcomers)
        w = self._pick_width(m, len(queue))
        ordered = list(enumerate([t for _, t, _ in survivors] + newcomers))
        Bop = self._upload(op, ordered[0][1].b.shape[0], w,
                           [(i, t.b) for i, t in ordered])
        X0 = None
        if survivors:
            xs = batch.state.x[:, [j for j, _, _ in survivors]]
            pad = xs.new_zeros((xs.shape[0], w - xs.shape[1]))
            X0 = torch.cat([xs, pad], dim=1)
        batch.state = batch.init(Bop, self._tols(op, ordered, w), X0)
        batch.width = w
        batch.slots = [None] * w
        batch.insert_it = [0] * w
        for i, (_, ticket, spent) in enumerate(survivors):
            batch.slots[i] = ticket
            batch.insert_it[i] = -spent if spent else 0
        for i, ticket in enumerate(newcomers, start=len(survivors)):
            batch.slots[i] = ticket
        self.stats["refills"] += 1

    def _chunk_k(self, batch: _Batch, now: float) -> int:
        """Iterations for the next chunk, shrunk toward the tightest live
        deadline and snapped to a power of two (:func:`snap_chunk`)."""
        deadlines = [t.deadline for t in batch.slots
                     if t is not None and t.deadline is not None
                     and not t._cancel_requested]
        if not deadlines or not batch.est_iter_s:
            return self.chunk_iters
        remaining = min(deadlines) - now
        if remaining <= 0:
            k = 1                       # expired: reach the boundary asap
        else:
            k = int(remaining / batch.est_iter_s)
        k = snap_chunk(k, self.chunk_iters)
        if k < self.chunk_iters:
            self.stats["deadline_chunks"] += 1
        return k

    def _run_chunk(self, batch: _Batch) -> Optional[np.ndarray]:
        """Advance the batch one chunk; returns its ``done`` flags on the
        host (None when a refill admitted nothing).

        ``run_chunk`` returns once the chunk's last iteration is enqueued,
        so the flags are read before the clock: the measured wall is the
        card's time for the chunk, not Python's time to enqueue it.
        :meth:`_retire_and_refill` takes the same host copy.
        """
        if batch.state is None:
            return None
        now = self.clock()
        k = self._chunk_k(batch, now)
        it0 = batch.state.it
        batch.state = batch.step(batch.op, batch.state, k, M=batch.M)
        done = self._download(batch.state.done)
        advanced = batch.state.it - it0
        wall = self.clock() - now
        if wall > 0 and advanced > 0:
            # EWMA of measured per-iteration time feeds deadline slack
            # and chunk shrinking; a virtual clock that does not advance
            # inside the step leaves the cold hint in place
            per_iter = wall / advanced
            batch.est_iter_s = (per_iter if batch.est_iter_s is None
                                else 0.7 * batch.est_iter_s + 0.3 * per_iter)
        self.stats["chunks"] += 1
        return done

    def _retire_and_refill(self, batch: _Batch,
                           done: Optional[np.ndarray]) -> None:
        """Retire finished, cancelled and expired columns, given the host
        ``done`` flags of the chunk just run, then refill."""
        if batch.state is None:
            self._refill(batch)
            return
        now = self.clock()
        state = batch.state
        block_it = state.it
        # (slot, ticket, spent, status) for tickets that get a result;
        # cancellations resolve without one and win over a convergence
        # observed at the same boundary (cancel() promised)
        retiring: List[Tuple[int, SolveTicket, int, str]] = []
        for j, ticket in enumerate(batch.slots):
            if ticket is None:
                continue
            spent = block_it - batch.insert_it[j]
            if ticket._cancel_requested:
                batch.slots[j] = None
                ticket._finish("cancelled", now)
                self.completed.append(ticket)
                self.stats["cancelled"] += 1
            elif done[j] or spent >= ticket.maxiter:
                retiring.append((j, ticket, spent, "done"))
            elif ticket.deadline is not None and now >= ticket.deadline:
                # running past its deadline: retire with the best-effort
                # iterate (column and block batches alike)
                retiring.append((j, ticket, spent, "expired"))
        if retiring:
            res = batch.finalize(state)              # one readout per sweep
            resn = self._download(res.resnorm)
            for j, ticket, spent, status in retiring:
                # one contiguous column each: a strided (n, m) block
                # comes back several times slower
                x = self._download(batch.op.from_op_space(res.x[:, j]))
                ticket.result = ServiceResult(
                    x=x, iters=spent, resnorm=float(resn[j]),
                    converged=bool(done[j]))
                ticket._finish(status, now)
                batch.slots[j] = None
                self.completed.append(ticket)
                if status == "done":
                    self.stats["retired"] += 1
                    self.stats["converged"] += int(done[j])
                else:
                    self.stats["expired"] += 1
        self._refill(batch)

    # ------------------------------------------- spectral (KPM/ChebFD) side
    def kpm_moments(self, matrix: str, n_moments: int, **kw):
        """KPM DOS moments using the registry's cached spectral bounds."""
        op = self.registry.operator(matrix)
        spectrum = kw.pop("spectrum", None) or \
            self.registry.spectral_bounds(matrix)
        return kpm_dos_moments(op, n_moments, spectrum=spectrum, **kw)

    def chebfd(self, matrix: str, target: Tuple[float, float], **kw):
        """Chebyshev filter diagonalization with cached spectral bounds."""
        op = self.registry.operator(matrix)
        spectrum = kw.pop("spectrum", None) or \
            self.registry.spectral_bounds(matrix)
        return chebfd(op, target, spectrum=spectrum, **kw)

    def describe(self) -> str:
        qs = {"/".join(map(str, k)): len(q)
              for k, q in self._queues.items() if q}
        return (f"SolverService(width={self.block_width}, "
                f"chunk={self.chunk_iters}, admission={self.admission}, "
                f"batches={len(self._batches)}, "
                f"queued={qs}, stats={self.stats})")
