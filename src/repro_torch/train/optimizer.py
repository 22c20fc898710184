"""Optimizers on lists of tensors, the learning-rate schedule, global-norm
clipping and int8 gradient quantization.

The port of ``repro/train/optimizer.py``, function for function, each on
a list of tensors where the JAX package takes a pytree (the trainer hands
over the leaves in the JAX tree's order):

* AdamW: float32 first and second moments beside parameters of any
  dtype, b2 = 0.95, eps added outside the square root, weight decay only
  on tensors of two or more dimensions, the update formed in float32 and
  cast back to the parameter's dtype.  ``torch.optim.AdamW`` differs on
  each of these points (moments in the parameter's dtype, decay on every
  tensor, the update in the parameter's dtype), so it is not used.
* Adafactor: factored second moment for tensors of two or more
  dimensions, no first moment, RMS update clipping.
* Global-norm clipping and a warmup + cosine schedule.
* int8 quantization with a per-tensor scale, and ``compressed_psum``,
  the int8 (or bf16) all-reduce over a process group.

The updates work in place: parameters, moments and gradients (clipping)
are overwritten, one tensor at a time, so the float32 temporaries of one
tensor are the only memory they add.  Each function returns what it
updated, as the JAX one returns the new values.

``compressed_psum`` is wired into nothing, as in the JAX package: a mesh
axis there is a process group here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["adamw_init", "adamw_update", "adafactor_init", "adafactor_update",
           "clip_by_global_norm", "warmup_cosine", "make_optimizer",
           "quantize_int8", "dequantize_int8", "compressed_psum",
           "Optimizer"]


# ---------------------------------------------------------------- schedules
def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable[[int], float]:
    """``lr(step)``: linear warmup over ``warmup`` steps, then a cosine
    from ``base_lr`` down to ``min_frac * base_lr`` at ``total``.  The
    arithmetic is float32, as in the JAX package; the result is a Python
    float."""
    def lr(step) -> float:
        s = torch.tensor(float(step), dtype=torch.float32)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return float(warm if float(s) < warmup else cos)
    return lr


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns ``(grads, norm)`` with the norm before scaling
    (a float32 scalar tensor).  Each gradient is scaled in float32 and
    rounded back to its dtype."""
    g2 = sum(torch.sum(torch.square(g.float())) for g in grads)
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return list(grads), norm


# ------------------------------------------------------------------- AdamW
def _count(params) -> torch.Tensor:
    dev = params[0].device if len(params) else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params: Sequence[torch.Tensor]) -> Dict:
    """``{"m": [...], "v": [...], "count"}``: float32 zeros shaped like
    each parameter, and an int32 step count."""
    params = list(params)
    return {"m": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in params],
            "v": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in params],
            "count": _count(params)}


@torch.no_grad()
def adamw_update(grads, state, params, lr: float, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """One AdamW step, in place on ``params`` and the moments of
    ``state``; returns ``(params, state)`` with the new count."""
    c = state["count"] + 1
    cf = c.float()
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf
    for g, m, v, p in zip(grads, state["m"], state["v"], params):
        gf = g.float()
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        step = m / bc1
        step.div_(torch.sqrt(v / bc2).add_(eps))
        del gf
        if p.ndim >= 2:                       # no decay on norms/bias
            step.add_(weight_decay * p.float())
        p.copy_(p.float().sub_(lr * step))
    return list(params), {"m": state["m"], "v": state["v"], "count": c}


# --------------------------------------------------------------- Adafactor
def adafactor_init(params: Sequence[torch.Tensor]) -> Dict:
    """``{"slots": [...], "count"}``: per parameter of two or more
    dimensions the row and column second moments ``{"vr", "vc"}``, else
    the full one ``{"v"}``, all float32 zeros."""
    params = list(params)

    def one(p):
        z = dict(dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}

    return {"slots": [one(p) for p in params], "count": _count(params)}


@torch.no_grad()
def adafactor_update(grads, state, params, lr: float, *, decay=0.8,
                     eps=1e-30, clip_thresh=1.0, weight_decay=0.0):
    """One Adafactor step, in place on ``params``; returns ``(params,
    state)`` with new slots and count."""
    c = state["count"] + 1
    beta = 1.0 - c.float() ** (-decay)
    slots = []
    for g, slot, p in zip(grads, state["slots"], params):
        gf = g.float()
        g2 = gf * gf + eps
        if p.ndim >= 2:
            vr = beta * slot["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * slot["vc"] + (1 - beta) * g2.mean(dim=-2)
            denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            prec = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            step = gf / torch.sqrt(torch.clamp(prec, min=eps))
            slots.append({"vr": vr, "vc": vc})
        else:
            v = beta * slot["v"] + (1 - beta) * g2
            step = gf / torch.sqrt(torch.clamp(v, min=eps))
            slots.append({"v": v})
        # update clipping (RMS)
        rms = torch.sqrt(torch.mean(step * step) + 1e-12)
        step = step / torch.clamp(rms / clip_thresh, min=1.0)
        if weight_decay and p.ndim >= 2:
            step = step + weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    return list(params), {"slots": slots, "count": c}


# ------------------------------------------------------------- compression
def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: int8 values and a float32 scale with
    ``q * scale ~ x`` (round half to even, as ``jnp.round``)."""
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(x: torch.Tensor, group=None, *, bits: int = 8
                    ) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``None``: the default
    group), quantized on the wire: each rank scales by the largest
    ``max|x| / 127 + 1e-12`` of the group (a MAX all-reduce), rounds
    ``x / scale`` half to even into [-127, 127], sums the integers as
    int32 (a SUM all-reduce) and returns ``sum * scale`` in ``x``'s dtype
    -- 4x less traffic than float32 (the JAX package's int32 psum carries
    the same values).  ``bits == 16``: a bfloat16 SUM all-reduce, cast
    back.  Every rank gets the same result; ``x`` is not changed."""
    if bits == 16:
        y = x.to(torch.bfloat16, copy=True)
        dist.all_reduce(y, dist.ReduceOp.SUM, group=group)
        return y.to(x.dtype)
    xf = x.float()
    _, scale = quantize_int8(xf)
    dist.all_reduce(scale, dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, dist.ReduceOp.SUM, group=group)
    return (q.float() * scale).to(x.dtype)


# ------------------------------------------------------------------ facade
@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    name: str


def make_optimizer(kind: str, **kw) -> Optimizer:
    if kind == "adamw":
        return Optimizer(adamw_init,
                         lambda g, s, p, lr: adamw_update(g, s, p, lr, **kw),
                         "adamw")
    if kind == "adafactor":
        return Optimizer(adafactor_init,
                         lambda g, s, p, lr: adafactor_update(g, s, p, lr,
                                                              **kw),
                         "adafactor")
    raise ValueError(kind)
