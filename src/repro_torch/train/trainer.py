"""Trainer: the train step, fault tolerance, elasticity and straggler
monitoring, on one device or on a ``("data", "model")`` mesh of ranks.

The port of ``repro/train/trainer.py``.

* The model is the port's :class:`~repro_torch.models.transformer.Model`
  (``init_params(cfg, seed)`` unless ``init_model`` builds another), its
  weights turned trainable with ``requires_grad_(True)``.  The JAX
  package stacks each decoder (and encoder) weight over the pattern's
  periods and its optimizer sees the stacked leaf (weight decay and
  Adafactor's factoring follow the stacked shape); here every such leaf
  is one tensor of that stacked shape, and each period's parameter is a
  view of its slice, so the optimizer, the checkpoint and the model share
  one copy of the weights.  The leaves are kept in the JAX tree's order
  (its paths, sorted).
* Gradients flow through ``loss_fn`` with per-period remat;
  ``grad_accum`` micro-batches accumulate in float32 and report the last
  micro-batch's metrics, as the JAX ``lax.scan`` does; then global-norm
  clipping, the warmup + cosine schedule, AdamW or Adafactor.
* Checkpoint/restart: ``CheckpointManager`` in the JAX package's format
  (a checkpoint crosses between the packages); the data pipeline is
  stateless in the step, so a restart resumes exactly.
* Straggler mitigation: a step-time EWMA flags slow steps and calls
  ``rebalance_cb(step, dt, ewma)``.

On a mesh (``mesh``, a ``DeviceMesh`` from ``launch.mesh.make_host_mesh``;
every rank builds its own ``Trainer``) the step is the one-device step
of the global batch, as the JAX ``Trainer``'s jitted step on its mesh:

* every rank draws the same full model and keeps it whole: the model
  axis splits no arithmetic (below), so the forward needs every full
  leaf.  What a rank holds as its shard is its optimizer state: each
  slot's shard by ``opt_specs`` over ``param_specs`` (the JAX leaf
  paths; the layout is ``sharding.set_layout``'s).  A rank thus holds
  the full parameters, the full gradient during a step and its slot
  shards, where a JAX device holds its parameter shards too;
* it takes its rows of each micro-batch (``make_global_batch`` by
  ``batch_specs`` of the micro-batch); the gradients, the loss and the
  metrics are averaged over the ranks that hold different rows (the
  batch spec's axes), so every rank holds the global batch's gradient
  and loss, and the MoE layers dispatch the rank's rows as its part of
  the global batch (``moe.RowShare``: the global capacity, the same
  dropped tokens, the global load-balancing statistics);
* it clips by that gradient's global norm and updates its share:
  AdamW, elementwise, the region of each leaf that its slot shards
  cover, then gathers the updated leaf; Adafactor's row and column
  statistics span the whole leaf, so it updates the full leaf from
  the gathered slots and keeps its slices;
* the model axis shards storage, not arithmetic: the ranks of one model
  group see the same rows and compute the same step (no column- or
  row-parallel products);
* a checkpoint holds the logical leaves (the slots gathered), written
  by rank 0 and restored by every rank onto its current mesh (elastic
  restore);
* rank 0 logs and calls ``rebalance_cb``; every rank reports the global
  loss.
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.execution import resolve_device
from repro_torch.data.pipeline import (SyntheticLM, make_global_batch,
                                       to_device)
from repro_torch.interop import leaf_groups, nest
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as MOE
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as OPT
from repro_torch.train.checkpoint import CheckpointManager

__all__ = ["TrainConfig", "Trainer", "stack_leaves"]

#: the axes of one device, a mesh of one position
ONE_DEVICE = {"data": 1, "model": 1}


@dataclasses.dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    clip_norm: float = 1.0
    optimizer: str = "adamw"          # adamw | adafactor
    weight_decay: float = 0.1
    grad_accum: int = 1
    seed: int = 0
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    straggler_thresh: float = 2.0     # x EWMA step time -> flagged


def stack_leaves(model: T.Model):
    """The model's weights as the JAX package's leaves: ``(keys, leaves,
    groups)``, with ``keys`` the sorted tree paths
    (:func:`~repro_torch.interop.leaf_groups`), ``leaves`` one tensor per
    key (a decoder or encoder weight stacked over the periods on axis 0)
    and ``groups`` the parameters of each leaf with whether it is
    stacked.  Each period's parameter is made a view of its slice of the
    stacked tensor, so an update of the leaf is an update of the model."""
    groups = leaf_groups(model)
    leaves = []
    with torch.no_grad():
        for _, ps, stacked in groups:
            if stacked:
                W = torch.stack([p.detach() for p in ps])
                for i, p in enumerate(ps):
                    p.data = W[i]
                leaves.append(W)
            else:
                leaves.append(ps[0].detach())
    return ([k for k, _, _ in groups], leaves,
            [(ps, stacked) for _, ps, stacked in groups])


def _get(tree, key):
    for seg in key.split("/"):
        tree = tree[seg]
    return tree


def _opt_tree(state, keys) -> dict:
    """An optimizer state as the JAX package's tree: each per-leaf list
    nested under the leaf paths."""
    return {k: nest(keys, v) if isinstance(v, list) else v
            for k, v in state.items()}


def _opt_flat(state, keys) -> Dict[str, torch.Tensor]:
    """An optimizer state's tensors by the JAX package's paths (``m/<leaf
    path>``, ``slots/<leaf path>/vr``, ``count``)."""
    return SH.flatten(_opt_tree(state, keys))


def _opt_unflat(like, keys, flat):
    """The optimizer state of ``like``'s form holding ``flat``'s tensors."""
    def one(name, k, v):
        if isinstance(v, dict):
            return {s: flat[f"{name}/{k}/{s}"] for s in v}
        return flat[f"{name}/{k}"]
    return {name: [one(name, k, v) for k, v in zip(keys, val)]
            if isinstance(val, list) else flat[name]
            for name, val in like.items()}


class Trainer:
    def __init__(self, cfg: T.ModelConfig, tc: TrainConfig, mesh=None, *,
                 seq_len: int, global_batch: int,
                 rebalance_cb: Optional[Callable] = None, device=None,
                 init_model: Optional[Callable[[], T.Model]] = None):
        self.cfg = cfg
        self.tc = tc
        self.mesh = mesh
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.rebalance_cb = rebalance_cb
        self.device = resolve_device(device)
        self.init_model = init_model or (
            lambda: T.init_params(cfg, tc.seed, self.device))
        self.opt = OPT.make_optimizer(
            tc.optimizer, weight_decay=tc.weight_decay
        ) if tc.optimizer == "adamw" else OPT.make_optimizer(tc.optimizer)
        self.lr_fn = OPT.warmup_cosine(tc.lr, tc.warmup, tc.total_steps)
        self.model: Optional[T.Model] = None
        # one device is the mesh of one position: every spec keeps its
        # leaf whole there and no collective runs
        if mesh is None:
            self.rank, self.view, self.coord = 0, Mesh(ONE_DEVICE), (0, 0)
        else:
            self.rank, self.view = dist.get_rank(), Mesh.of(mesh)
            self.coord = tuple(mesh.get_coordinate())
        self.ckpt = CheckpointManager(
            tc.ckpt_dir, every=tc.ckpt_every, keep=tc.ckpt_keep,
            writer=self.rank == 0,
            barrier=None if mesh is None else dist.barrier)
        # the ranks that hold different rows of a micro-batch: its batch
        # spec's axes (none where the guard replicates the rows)
        micro = torch.empty((global_batch // tc.grad_accum, seq_len),
                            device="meta")
        rows = SH.batch_specs(cfg, {"tokens": micro}, self.view)["tokens"][0]
        self.batch_axes = tuple(a for a in SH.axes_of(rows)
                                if self.view.shape[a] > 1)
        self.n_batch = math.prod(self.view.shape[a] for a in self.batch_axes)
        self.rows = None
        if self.n_batch > 1:
            n = self.n_batch
            self.rows = MOE.RowShare(
                gather=lambda t: SH.gather(t[None], (rows,),
                                           (n,) + tuple(t.shape), mesh),
                index=SH.shard_index((rows,), (n,), self.view,
                                     self.coord)[0].start)

    # ------------------------------------------------------------ state
    def init_state(self):
        """A fresh model with trainable weights and its optimizer state;
        returns ``(model, opt_state)``.  ``params`` are the model's full
        (stacked) leaves, on a mesh too; ``opt_state`` holds this rank's
        shard of each slot."""
        model = self.init_model()
        model.requires_grad_(True)
        self.model = model
        self.keys, self.params, self._groups = stack_leaves(model)
        pspecs = SH.param_specs(self.cfg, dict(zip(self.keys, self.params)),
                                self.view)
        self._opt_like = self.opt.init([p.to("meta") for p in self.params])
        like = _opt_flat(self._opt_like, self.keys)
        self.ospecs = SH.opt_specs(pspecs, like, self.view)
        # every slot (and the count) of both optimizers starts at zero
        self.opt_state = _opt_unflat(self._opt_like, self.keys, {
            path: torch.zeros(t[self._index(self.ospecs[path], t.shape)].shape,
                              dtype=t.dtype, device=self.device)
            for path, t in like.items()})
        return model, self.opt_state

    def _index(self, spec, shape):
        return SH.shard_index(spec, shape, self.view, self.coord)

    def _sharded(self, spec) -> bool:
        return any(self.view.shape[a] > 1 for e in spec for a in SH.axes_of(e))

    def _slice(self, full: torch.Tensor, spec) -> torch.Tensor:
        """This rank's slice of ``full`` under ``spec``: a tensor of its
        own where ``spec`` shards the leaf, else ``full`` itself."""
        if not self._sharded(spec):
            return full
        return full[self._index(spec, full.shape)].clone(
            memory_format=torch.contiguous_format)

    def _gather(self, local, spec, shape):
        if not self._sharded(spec):
            return local
        return SH.gather(local, spec, shape, self.mesh)

    def opt_leaves(self, full: bool = False) -> Dict[str, torch.Tensor]:
        """The optimizer state by the JAX package's paths (``m/<leaf
        path>``, ``slots/<leaf path>/vr``, ``count``): the tensors this
        rank holds, or with ``full`` the full leaves' shapes and dtypes
        on ``meta``."""
        return _opt_flat(self._opt_like if full else self.opt_state,
                         self.keys)

    def _full_opt_state(self):
        flat = _opt_flat(self.opt_state, self.keys)
        like = _opt_flat(self._opt_like, self.keys)
        return _opt_unflat(self.opt_state, self.keys, {
            path: self._gather(t, self.ospecs[path], like[path].shape)
            for path, t in flat.items()})

    def _keep_opt_slices(self, full_state) -> None:
        self.opt_state = _opt_unflat(full_state, self.keys, {
            path: self._slice(t, self.ospecs[path])
            for path, t in _opt_flat(full_state, self.keys).items()})

    def state_tree(self):
        """The JAX package's ``(params, opt_state)`` tree of the current
        state (the checkpoint's tree): leaves under their paths, the
        optimizer's per-leaf lists nested the same way.  On a mesh the
        slots are gathered (a collective: every rank calls it)."""
        return (nest(self.keys, list(self.params)),
                _opt_tree(self._full_opt_state(), self.keys))

    def restore(self) -> int:
        """A fresh state (:meth:`init_state`), then the latest checkpoint
        in ``ckpt_dir`` loaded into it, on a mesh this rank's slices of
        its slots, whatever mesh wrote it; returns its step (0 without
        one)."""
        self.init_state()
        like = (nest(self.keys, [p.to("meta") for p in self.params]),
                _opt_tree(self._opt_like, self.keys))
        restored, start = self.ckpt.resume(like)
        if restored is not None:
            self.load_state_tree(restored)
        return start

    @torch.no_grad()
    def load_state_tree(self, tree) -> None:
        """Copy a tree of :meth:`state_tree`'s form (full leaves) into the
        state: the parameters whole, of each slot this rank's slice."""
        params, opt = tree
        for k, p in zip(self.keys, self.params):
            p.copy_(_get(params, k))
        src = SH.flatten(opt)
        for path, dst in _opt_flat(self.opt_state, self.keys).items():
            val = src[path]
            dst.copy_(val[self._index(self.ospecs[path], val.shape)])

    # ------------------------------------------------------------- step
    def _loss_and_grads(self, batch):
        """Loss, metrics and one gradient per leaf (stacked like it)."""
        loss, metrics = T.loss_fn(self.cfg, self.model, batch, self.rows)
        flat = [p for ps, _ in self._groups for p in ps]
        gs = list(torch.autograd.grad(loss, flat, allow_unused=True,
                                      materialize_grads=True))
        grads, i = [], 0
        for ps, stacked in self._groups:
            n = len(ps)
            grads.append(torch.stack(gs[i:i + n]) if stacked else gs[i])
            gs[i:i + n] = [None] * n
            i += n
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def _accumulate(self, batch):
        accum = self.tc.grad_accum
        if accum == 1:
            return self._loss_and_grads(batch)
        mb = batch["tokens"].shape[0] // accum
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in self.params]
        lsum = 0.0
        for a in range(accum):
            sub = {k: v[a * mb:(a + 1) * mb] for k, v in batch.items()}
            loss, metrics, grads = self._loss_and_grads(sub)
            for s, g in zip(gsum, grads):
                s.add_(g.float())
            lsum = lsum + loss
        return lsum / accum, metrics, [g / accum for g in gsum]

    def _batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged in place over the ranks that hold other rows."""
        for a in self.batch_axes:
            dist.all_reduce(t, dist.ReduceOp.SUM, group=self.mesh.get_group(a))
        return t.div_(self.n_batch)

    def compute_grads(self, batch):
        """``(loss, metrics, grads)`` of one global batch: the gradients in
        the leaves' dtype, or with ``grad_accum`` > 1 the float32 mean over
        the micro-batches (and the mean loss, the last micro-batch's
        metrics).  On a mesh ``batch`` is this rank's rows
        (:meth:`local_batch`), and the results are the global batch's, on
        every rank."""
        loss, metrics, grads = self._accumulate(batch)
        if self.rows is None:
            return loss, metrics, grads
        for g in grads:
            self._batch_mean(g)
        names = list(metrics)
        vals = self._batch_mean(torch.stack(
            [loss.float()] + [metrics[n].float() for n in names]))
        return vals[0], dict(zip(names, vals[1:])), grads

    @torch.no_grad()
    def _update(self, grads, lr: float) -> None:
        """The optimizer step on this rank's shards (see the module's
        docstring)."""
        if self.opt.name == "adamw":
            # elementwise: this rank updates the region of each leaf that
            # its slot shards cover, then gathers the updated leaf
            region = [self.ospecs[f"m/{k}"] for k in self.keys]
            idx = [self._index(r, p.shape) for r, p in zip(region, self.params)]
            _, self.opt_state = self.opt.update(
                [g[i] for g, i in zip(grads, idx)], self.opt_state,
                [p[i] for p, i in zip(self.params, idx)], lr)
            for p, r, i in zip(self.params, region, idx):
                if self._sharded(r):
                    p.copy_(SH.gather(p[i], r, p.shape, self.mesh))
        else:
            # the row and column statistics span the whole leaf
            _, full_state = self.opt.update(grads, self._full_opt_state(),
                                            self.params, lr)
            self._keep_opt_slices(full_state)

    def apply_grads(self, grads, step: int):
        """Clip, schedule and update in place; returns ``(gnorm, lr)``."""
        grads, gnorm = OPT.clip_by_global_norm(grads, self.tc.clip_norm)
        lr = self.lr_fn(step)
        self._update(grads, lr)
        return gnorm, lr

    def train_step(self, batch, step: int) -> Dict[str, Any]:
        """One step on ``batch`` (tensors on the device; on a mesh this
        rank's rows, :meth:`local_batch`); returns the metrics ``{"ce",
        "aux", "loss", "gnorm", "lr"}``."""
        loss, metrics, grads = self.compute_grads(batch)
        gnorm, lr = self.apply_grads(grads, step)
        return dict(metrics, loss=loss, gnorm=gnorm, lr=lr)

    def local_batch(self, batch: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
        """A host batch as this trainer's step takes it: on one device the
        whole batch on the device; on a mesh this rank's rows of each of
        the ``grad_accum`` micro-batches, in order (so that its own
        micro-batch ``a`` is its share of the global micro-batch ``a``)."""
        if self.mesh is None:
            return to_device(batch, self.device)
        accum = self.tc.grad_accum
        mb = next(iter(batch.values())).shape[0] // accum
        parts = []
        for a in range(accum):
            sub = {k: v[a * mb:(a + 1) * mb] for k, v in batch.items()}
            specs = SH.batch_specs(self.cfg, sub, self.view)
            parts.append(make_global_batch(sub, self.mesh, specs,
                                           self.device))
        return {k: torch.cat([p[k] for p in parts]) for k in batch}

    # -------------------------------------------------------------- fit
    def fit(self, steps: int, *, data: Optional[SyntheticLM] = None,
            log: Callable = print) -> Dict[str, Any]:
        """Train up to step ``steps``, resuming from the latest checkpoint
        in ``ckpt_dir``; returns ``{"params": the model, "opt_state",
        "losses"}`` with this call's losses (on a mesh the global ones,
        on every rank; only rank 0 logs)."""
        data = data or SyntheticLM(self.cfg.vocab_size, self.seq_len,
                                   self.global_batch, seed=self.tc.seed)
        if self.rank != 0:
            log = _silent
        start = self.restore()
        if start:
            log(f"[trainer] resumed from step {start}")

        ewma = None
        losses = []
        for step in range(start, steps):
            b = self.local_batch(data.batch(step))
            t0 = time.perf_counter()
            m = self.train_step(b, step)
            loss = float(m["loss"])
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > self.tc.straggler_thresh * ewma and step > start + 2:
                log(f"[trainer] straggler step {step}: {dt:.3f}s vs "
                    f"EWMA {ewma:.3f}s")
                if self.rebalance_cb and self.rank == 0:
                    self.rebalance_cb(step, dt, ewma)
            losses.append(loss)
            if step % self.tc.log_every == 0:
                log(f"[trainer] step {step} loss {loss:.4f} "
                    f"gnorm {float(m['gnorm']):.3f} ({dt * 1e3:.0f} ms)")
            self.ckpt.maybe_save(step + 1, self.state_tree,
                                 extra={"loss": loss})
        self.ckpt.maybe_save(steps, self.state_tree, force=True)
        return {"params": self.model, "opt_state": self.opt_state,
                "losses": losses}


def _silent(*_args, **_kw) -> None:
    pass
