"""Trainer: the train step, fault tolerance and straggler monitoring, on one
device.

The port of ``repro/train/trainer.py`` without a mesh: on one card
``param_specs``, ``opt_specs`` and ``batch_specs`` have nothing to place,
so the step is a plain function of the model, the optimizer state and a
batch.

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
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.execution import resolve_device
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.interop import leaf_groups, nest
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as OPT
from repro_torch.train.checkpoint import CheckpointManager

__all__ = ["TrainConfig", "Trainer", "stack_leaves"]


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


class Trainer:
    def __init__(self, cfg: T.ModelConfig, tc: TrainConfig, *, seq_len: int,
                 global_batch: int, rebalance_cb: Optional[Callable] = None,
                 device=None,
                 init_model: Optional[Callable[[], T.Model]] = None):
        self.cfg = cfg
        self.tc = tc
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
        self.ckpt = CheckpointManager(tc.ckpt_dir, every=tc.ckpt_every,
                                      keep=tc.ckpt_keep)
        self.model: Optional[T.Model] = None

    # ------------------------------------------------------------ state
    def init_state(self):
        """A fresh model with trainable weights and its optimizer state;
        returns ``(model, opt_state)``."""
        model = self.init_model()
        model.requires_grad_(True)
        self.model = model
        self.keys, self.params, self._groups = stack_leaves(model)
        self.opt_state = self.opt.init(self.params)
        return model, self.opt_state

    def state_tree(self):
        """The JAX package's ``(params, opt_state)`` tree of the current
        state (the checkpoint's tree): leaves under their paths, the
        optimizer's per-leaf lists nested the same way."""
        opt = {k: nest(self.keys, v) if isinstance(v, list) else v
               for k, v in self.opt_state.items()}
        return nest(self.keys, self.params), opt

    @torch.no_grad()
    def load_state_tree(self, tree) -> None:
        """Copy a tree of :meth:`state_tree`'s form into the state."""
        params, opt = tree
        for leaf, k in zip(self.params, self.keys):
            leaf.copy_(_get(params, k))
        for name, val in self.opt_state.items():
            if not isinstance(val, list):
                val.copy_(opt[name])
                continue
            for i, k in enumerate(self.keys):
                src = _get(opt[name], k)
                if isinstance(val[i], dict):
                    for s in val[i]:
                        val[i][s].copy_(src[s])
                else:
                    val[i].copy_(src)

    # ------------------------------------------------------------- step
    def _loss_and_grads(self, batch):
        """Loss, metrics and one gradient per leaf (stacked like it)."""
        loss, metrics = T.loss_fn(self.cfg, self.model, batch)
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

    def compute_grads(self, batch):
        """``(loss, metrics, grads)`` of one global batch: the gradients in
        the leaves' dtype, or with ``grad_accum`` > 1 the float32 mean over
        the micro-batches (and the mean loss, the last micro-batch's
        metrics)."""
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

    def apply_grads(self, grads, step: int):
        """Clip, schedule and update in place; returns ``(gnorm, lr)``."""
        grads, gnorm = OPT.clip_by_global_norm(grads, self.tc.clip_norm)
        lr = self.lr_fn(step)
        self.params, self.opt_state = self.opt.update(
            grads, self.opt_state, self.params, lr)
        return gnorm, lr

    def train_step(self, batch, step: int) -> Dict[str, Any]:
        """One step on ``batch`` (tensors on the device); returns the
        metrics ``{"ce", "aux", "loss", "gnorm", "lr"}``."""
        loss, metrics, grads = self.compute_grads(batch)
        gnorm, lr = self.apply_grads(grads, step)
        return dict(metrics, loss=loss, gnorm=gnorm, lr=lr)

    # -------------------------------------------------------------- fit
    def fit(self, steps: int, *, data: Optional[SyntheticLM] = None,
            log: Callable = print) -> Dict[str, Any]:
        """Train up to step ``steps``, resuming from the latest checkpoint
        in ``ckpt_dir``; returns ``{"params": the model, "opt_state",
        "losses"}`` with this call's losses."""
        data = data or SyntheticLM(self.cfg.vocab_size, self.seq_len,
                                   self.global_batch, seed=self.tc.seed)
        self.init_state()
        restored, start = self.ckpt.resume(self.state_tree())
        if restored is not None:
            self.load_state_tree(restored)
            log(f"[trainer] resumed from step {start}")

        ewma = None
        losses = []
        for step in range(start, steps):
            b = to_device(data.batch(step), self.device)
            t0 = time.perf_counter()
            m = self.train_step(b, step)
            loss = float(m["loss"])
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > self.tc.straggler_thresh * ewma and step > start + 2:
                log(f"[trainer] straggler step {step}: {dt:.3f}s vs "
                    f"EWMA {ewma:.3f}s")
                if self.rebalance_cb:
                    self.rebalance_cb(step, dt, ewma)
            losses.append(loss)
            if step % self.tc.log_every == 0:
                log(f"[trainer] step {step} loss {loss:.4f} "
                    f"gnorm {float(m['gnorm']):.3f} ({dt * 1e3:.0f} ms)")
            self.ckpt.maybe_save(step + 1, self.state_tree(),
                                 extra={"loss": loss})
        self.ckpt.maybe_save(steps, self.state_tree(), force=True)
        return {"params": self.model, "opt_state": self.opt_state,
                "losses": losses}
