"""Mixture-of-Experts layer with GHOST-style sparse dispatch, in PyTorch.

The port of ``repro/models/moe.py``.  The token -> expert dispatch is a
sparse selection operator.  ``_ghost_dispatch`` sorts the (token, slot)
pairs by expert (the analogue of GHOST's sigma-sort), finds each pair's
position inside its expert with a segment start, and gathers/scatters with
integer index vectors, never a one-hot tensor; ``_dense_dispatch`` is the
one-hot (T, K, E, capacity) baseline.

A trainer whose global batch is split over ranks passes ``rows``
(:class:`RowShare`): each rank dispatches its own rows as its part of
the global batch's dispatch, as the JAX package's step on a mesh
dispatches the global batch.  The capacity is the global batch's, a
rank's (token, slot) pairs take their place in each expert after the
pairs of the ranks before it in row order (so the same pairs are
dropped), and the load-balancing statistics are the global batch's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.models.layers import dense_init, gelu_as, params, silu_as

__all__ = ["MoEConfig", "RowShare", "moe_init", "moe_apply"]


@dataclasses.dataclass(frozen=True)
class RowShare:
    """This rank's share of a batch whose rows are split over ``n``
    ranks in equal blocks: ``gather(t)`` stacks every rank's ``t`` into
    ``(n, *t.shape)`` in the order of their rows (a collective), and
    ``index`` is this rank's place in that order."""
    gather: Callable[[torch.Tensor], torch.Tensor]
    index: int


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    ghost_dispatch: bool = True      # sparse (sort + gather) vs dense one-hot
    router_jitter: float = 0.0


def moe_init(gen: torch.Generator, d_model, d_ff, cfg: MoEConfig, *,
             act="swiglu", dtype=torch.bfloat16) -> nn.ParameterDict:
    E = cfg.n_experts
    p = dict(router=dense_init(gen, d_model, (d_model, E), torch.float32),
             wi=dense_init(gen, d_model, (E, d_model, d_ff), dtype))
    if act == "swiglu":
        p["wg"] = dense_init(gen, d_model, (E, d_model, d_ff), dtype)
    p["wo"] = dense_init(gen, d_ff, (E, d_ff, d_model), dtype)
    return params(**p)


def _expert_ffn(p, xe, act):
    """xe: (E, cap, d) -> (E, cap, d), batched over experts."""
    h = torch.bmm(xe, p["wi"])
    if act == "swiglu":
        h = silu_as(torch.bmm(xe, p["wg"]), xe.dtype) * h
    else:
        h = gelu_as(h, xe.dtype)
    return torch.bmm(h, p["wo"])


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig, *, act="swiglu",
              generator: Optional[torch.Generator] = None,
              rows: Optional[RowShare] = None):
    """x: (B, S, d) -> ((B, S, d), aux losses dict).  Router jitter needs a
    ``generator`` (the JAX code's ``rng``).  With ``rows``, ``x`` is this
    rank's rows of the global batch (see the module's docstring)."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)

    logits = xt.float() @ p["router"]
    if cfg.router_jitter and generator is not None:
        logits = logits + cfg.router_jitter * torch.randn(
            logits.shape, generator=generator, device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)      # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=0)
    first = torch.bincount(expert_ids[:, 0], minlength=E).float()
    n, before = 1, None
    if rows is not None:
        # every rank's mean probabilities, first choices and (token,
        # slot) pairs per expert, in row order
        every = rows.gather(torch.stack([
            me.detach(), first,
            torch.bincount(expert_ids.reshape(-1), minlength=E).float()]))
        n = every.shape[0]
        # the global value, with this rank's gradient
        me = every[:, 0].mean(0) + (me - me.detach())
        first = every[:, 1].sum(0)
        before = every[:rows.index, 2].sum(0).long()
    ce = first / (T * n)
    aux = {"load_balance": E * torch.sum(me * ce)}

    cap = int(max(1, T * n * K * cfg.capacity_factor / E))
    dispatch = _ghost_dispatch if cfg.ghost_dispatch else _dense_dispatch
    out = dispatch(p, xt, expert_ids, gate_vals, E, K, cap, act, before)
    return out.reshape(B, S, d), aux


def _ghost_dispatch(p, xt, expert_ids, gate_vals, E, K, cap, act,
                    before=None):
    """Sparse dispatch: sort by expert (sigma-sort analogue), compressed
    integer gather/scatter (remote-column compression analogue).
    ``before`` (E,): the pairs each expert takes ahead of these tokens'
    (the ranks before this one); a pair is dropped at position ``cap``."""
    T, d = xt.shape
    dev = xt.device
    flat_e = expert_ids.reshape(T * K)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_g = gate_vals.reshape(T * K)

    order = torch.argsort(flat_e, stable=True)               # by expert
    e_sorted, t_sorted, g_sorted = flat_e[order], flat_t[order], flat_g[order]

    # position of each slot within its expert (compressed halo index)
    seg_start = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * K, device=dev) - seg_start[e_sorted]

    pos = pos_in_e if before is None else pos_in_e + before[e_sorted]
    keep = pos < cap                                         # capacity drop
    room = min(cap, T * K)             # the workspace's rows an expert
    slot = torch.where(keep, e_sorted * room + pos_in_e, E * room)

    # gather tokens into the (E*room, d) workspace; dropped slots land in
    # the spare last row
    buf = torch.zeros((E * room + 1, d), dtype=xt.dtype, device=dev)
    buf[slot] = xt[t_sorted]
    xe = buf[:E * room].reshape(E, room, d)

    ye = _expert_ffn(p, xe, act).reshape(E * room, d)

    # combine: weighted scatter-add back to tokens (the SpMMV y += A @ x
    # step, as a segment sum)
    contrib = ye[torch.where(keep, slot, 0)] * torch.where(
        keep, g_sorted, 0.0)[:, None].to(ye.dtype)
    out = torch.zeros((T, d), dtype=ye.dtype, device=dev)
    out.index_add_(0, t_sorted, contrib)
    return out.to(xt.dtype)


def _dense_dispatch(p, xt, expert_ids, gate_vals, E, K, cap, act,
                    before=None):
    """Conventional one-hot dispatch/combine (the 'dense storage'
    baseline); ``before`` as in :func:`_ghost_dispatch`."""
    T, d = xt.shape
    oh = torch.nn.functional.one_hot(expert_ids, E)          # (T, K, E)
    pos = torch.cumsum(oh.reshape(T * K, E), dim=0).reshape(T, K, E) - 1
    pos = torch.sum(pos * oh, dim=-1)                        # (T, K)
    keep = (pos if before is None else pos + before[expert_ids]) < cap
    room = min(cap, T * K)
    # a position at or past cap has an all-zero one-hot row, as in JAX
    oh_pos = torch.nn.functional.one_hot(pos.clamp(max=room - 1), room) \
        * keep[..., None]
    disp = (oh.to(xt.dtype)[..., :, None] * oh_pos.to(xt.dtype)[..., None, :])
    xe = torch.einsum("td,tkec->ecd", xt, disp)
    ye = _expert_ffn(p, xe, act)
    comb = disp * gate_vals[..., None, None].to(xt.dtype)
    return torch.einsum("ecd,tkec->td", ye, comb)
