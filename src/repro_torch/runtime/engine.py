"""The heterogeneous execution engine (GHOST sections 4.1 + 4.2).

The port of ``repro.runtime.engine``.  ``HeterogeneousEngine`` is the
piece that *decides* and *schedules*: it classifies the devices
(:class:`DevicePool`), derives roofline-proportional split weights,
builds the C-aligned :class:`SplitPlan` and the distributed SELL-C-sigma
matrix for it, and exposes pipelined (task-mode-overlapped) matvecs that
the solvers consume through
:class:`repro_torch.solvers.operator.DistOperator` unchanged.

Where the reference takes a ``mesh``, the engine takes ``devices``: one
torch device per shard.  The default is the pool's devices, and a
detected pool's default is every card, one shard a card, as the
reference's mesh spans ``jax.devices()``.  Shards may lie on any cards,
several may share one, and the host takes part only where the caller
names ``"cpu"`` among them (``["cuda:0", ..., "cuda:3", "cpu"]`` is the
host + 4 cards plan); a card shard launches kernel B1 or raises.  The
engine stays one process: the halo blocks move card to card on the
cards' side streams (:mod:`repro_torch.core.distributed`), and solver
vectors live on the first card (:class:`DistOperator`).

Rebalance loop: ``engine.rebalance(times)`` takes measured per-shard SpMV
times, performs one hill-climb step on the weights and redistributes the
matrix.  With no measurements it falls back to the pool's roofline model,
making the call idempotent on a perfectly modeled pool.

Typical use::

    eng = HeterogeneousEngine.from_coo(r, c, v, n, devices=["cuda", "cpu"])
    eng = HeterogeneousEngine.from_coo(r, c, v, n)        # one shard a card
    y, dots = eng.spmv(x, opts=SpmvOpts(dot_xy=True))     # global space
    res = cg(eng.operator(), b_op)                        # solver, unchanged
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.distributed import DistSellCS, dist_from_coo
from repro_torch.core.execution import canonical_device
from repro_torch.core.sellcs import _np_dtype, _torch_dtype
from repro_torch.core.spmv import SpmvOpts, as2d
from repro_torch.launch.costmodel import spmv_cost
from repro_torch.runtime.devicepool import DevicePool
from repro_torch.runtime.pipeline import make_pipeline_spmv
from repro_torch.runtime.split import SplitPlan, plan_split

__all__ = ["HeterogeneousEngine"]


class HeterogeneousEngine:
    """Cost-model-driven work splitting + overlapped halo pipeline."""

    def __init__(self, rows, cols, vals, nrows: int, *,
                 devices: Optional[Sequence] = None,
                 pool: Optional[DevicePool] = None,
                 weights: Optional[Sequence[float]] = None,
                 nshards: Optional[int] = None,
                 C: int = 32, sigma: int = 1, w_align: int = 1,
                 by_nnz: bool = True, dtype=None, store_dtype=None):
        self._rows = np.asarray(rows, np.int64)
        self._cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        self._vals = (vals if dtype is None
                      else vals.astype(_np_dtype(dtype), copy=False))
        self.nrows = int(nrows)
        self.C, self.sigma, self.w_align = C, sigma, w_align
        # matrix values shard-stored narrower than the compute dtype
        # (None = single-dtype); vectors/halo stay in the compute dtype
        self.store_dtype = (None if store_dtype is None
                            else _torch_dtype(store_dtype))

        self.pool = pool if pool is not None else DevicePool.detect(devices)
        if devices is None:
            devices = (self.pool.devices if self.pool.devices is not None
                       else [None] * (nshards or self.pool.ndevices))
        self.devices = tuple(canonical_device(d) for d in devices)
        self.nshards = int(nshards) if nshards else len(self.devices)
        if self.nshards != len(self.devices):
            raise ValueError(
                f"nshards={self.nshards} must equal the number of devices "
                f"({len(self.devices)}); name one device per shard")

        vb = self._val_bytes()
        if weights is None:
            w = self.pool.device_weights(nnz=len(self._vals),
                                         nrows=self.nrows, val_bytes=vb)
            # pool size and shard count may differ (e.g. tests); tile/trim
            w = np.resize(w, self.nshards)
        else:
            w = np.asarray(weights, np.float64)
            if len(w) != self.nshards:
                raise ValueError(f"expected {self.nshards} shard weights, "
                                 f"got {len(w)}")
        rowlen = None
        if by_nnz:
            rowlen = np.bincount(self._rows, minlength=self.nrows)
        self.plan: SplitPlan = plan_split(self.nrows, w, align=C,
                                          rowlen=rowlen)
        self._build()

    # ------------------------------------------------------------ plumbing
    @classmethod
    def from_coo(cls, rows, cols, vals, nrows, **kw) -> "HeterogeneousEngine":
        return cls(rows, cols, vals, nrows, **kw)

    def _val_bytes(self) -> int:
        """Bytes per stored matrix value — the roofline traffic number
        (the *storage* dtype: a bf16-stored matrix moves half the value
        bytes of its f32 compute dtype)."""
        if self.store_dtype is not None:
            return self.store_dtype.itemsize
        return int(self._vals.dtype.itemsize)

    def _build(self) -> None:
        self.A: DistSellCS = dist_from_coo(
            self._rows, self._cols, self._vals, self.nrows,
            nshards=self.plan.nshards, devices=self.devices, C=self.C,
            sigma=self.sigma, w_align=self.w_align,
            store_dtype=self.store_dtype, ranges=self.plan.ranges)
        self._matvec_cache: Dict[tuple, object] = {}

    def make_matvec(self, *, overlap: bool = True,
                    impl: Optional[str] = None, nvecs: int = 1,
                    with_y: bool = False, dot_yy: bool = False,
                    dot_xy: bool = False, dot_xx: bool = False,
                    has_gamma: bool = False, double_buffer: bool = False):
        """Cached pipelined matvec (see ``make_pipeline_spmv``), one per
        schedule, width and flag set of the current matrix."""
        key = (overlap, impl, nvecs, with_y, dot_yy, dot_xy, dot_xx,
               has_gamma, double_buffer)
        fn = self._matvec_cache.get(key)
        if fn is None:
            fn = make_pipeline_spmv(
                self.A, overlap=overlap, impl=impl, nvecs=nvecs,
                with_y=with_y, dot_yy=dot_yy, dot_xy=dot_xy, dot_xx=dot_xx,
                has_gamma=has_gamma, double_buffer=double_buffer)
            self._matvec_cache[key] = fn
        return fn

    # ------------------------------------------------------------- spmv API
    def spmv(self, x, y=None, *, opts: SpmvOpts = SpmvOpts(),
             overlap: bool = True, impl: Optional[str] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Global original-space fused SpM(M)V through the pipeline.
        Returns ``(y, dots)`` on the home device."""
        x2, was1d = as2d(torch.as_tensor(x))
        nvecs = x2.shape[1]
        xs = self.A.distribute_vec(x2)
        ys = None
        if y is not None:
            ys = self.A.distribute_vec(as2d(torch.as_tensor(y))[0])
        run = self.make_matvec(overlap=overlap, impl=impl, nvecs=nvecs,
                               with_y=y is not None,
                               dot_yy=opts.dot_yy, dot_xy=opts.dot_xy,
                               dot_xx=opts.dot_xx,
                               has_gamma=opts.gamma is not None)
        ys_out, dots, _ = run(xs, ys, opts)
        out = self.A.collect_vec(ys_out)
        if was1d:
            out = out[:, 0]
        return out, dots

    def on(self, devices: Sequence) -> "HeterogeneousEngine":
        """The same plan and matrix with shard ``p`` on ``devices[p]``
        (:meth:`DistSellCS.on`: the shards' tensors move, nothing is built
        again on the host).  The pool stays this engine's."""
        out = copy.copy(self)
        out.devices = tuple(canonical_device(d) for d in devices)
        out.A = self.A.on(out.devices)
        out._matvec_cache = {}
        return out

    def operator(self, **kw):
        """Solver-facing distributed operator (CG/Lanczos/KPM unchanged)."""
        from repro_torch.solvers.operator import DistOperator
        return DistOperator(self, **kw)

    # ------------------------------------------------------- rebalance loop
    def modeled_shard_times(self, nvecs: int = 1) -> np.ndarray:
        """Roofline time of each shard's SpMV on its assigned device."""
        classes = self.pool.device_classes()
        vb = self._val_bytes()
        times = []
        for i, (s, e) in enumerate(self.plan.ranges):
            cost = spmv_cost(int(self.A.shard_nnz[i]), max(e - s, 1),
                             val_bytes=vb, nvecs=nvecs)
            times.append(classes[i % len(classes)].time_for(cost))
        return np.asarray(times)

    def modeled_iter_seconds(self, nvecs: int = 1) -> float:
        """Roofline estimate of one block-SpMV sweep: the slowest shard —
        a *cold-start* seconds-per-iteration hint for deadline scheduling,
        which the serving frontend replaces with measured chunk times."""
        return float(np.max(self.modeled_shard_times(nvecs=nvecs)))

    def rebalance(self, measured_times: Optional[Sequence[float]] = None, *,
                  step: float = 0.5) -> "HeterogeneousEngine":
        """One hill-climb step on the split weights; redistributes A.

        ``measured_times[i]`` = observed SpMV seconds of shard ``i`` under
        the current plan (e.g. the ``times`` a matvec fills in).  Falls
        back to :meth:`modeled_shard_times`.  Returns ``self``.
        """
        t = (np.asarray(measured_times, np.float64)
             if measured_times is not None else self.modeled_shard_times())
        new_plan = self.plan.rebalance(t, step=step)
        if new_plan.ranges == self.plan.ranges:
            # at the fixed point (block granularity absorbed the weight
            # nudge): keep the matrix and the matvecs
            self.plan = new_plan
            return self
        self.plan = new_plan
        self._build()
        return self

    def __repr__(self) -> str:
        shares = "/".join(f"{w:.3f}" for w in self.plan.weights)
        return (f"HeterogeneousEngine(n={self.nrows}, shards={self.nshards}, "
                f"gen={self.plan.generation}, weights={shares}, "
                f"pool={self.pool!r})")
