"""Sharding rules: GHOST's data-parallel, weight-proportional distribution
philosophy (paper C4) mapped onto the pod mesh, as pure functions of leaf
shapes.

The port of ``repro/models/sharding.py``.  The dry run reads these specs
to size each device's shard of the production meshes
(``launch/mesh.py``); a trainer on a mesh of ranks places its leaves by
them (:func:`shard_index`, :func:`shard`, :func:`gather`, the
counterpart of ``named``).  A spec is a tuple with one entry
per dim: ``None``, an axis name, or a tuple of names, normalised as a JAX
``PartitionSpec`` normalises its entries (a one-name tuple becomes the
name, an empty one ``None``), so ``tuple(PartitionSpec)`` of the JAX
package equals the port's spec.  A tree of leaves is a flat mapping of
the JAX package's leaf path (``decoder/l0_mix/attn/wq``, as
``interop.leaf_groups`` gives it) to anything with ``.shape`` and
``.ndim``, a tensor on ``meta`` for instance.

Mesh axes: ``("pod", "data", "model")`` multi-pod / ``("data", "model")``
single-pod.  Strategy:

* batch over ``(pod, data)``;
* FSDP: every weight matrix shards one dim over ``data``;
* TP: attention head projections / MLP d_ff / mLSTM inner dim over
  ``model``;
* EP: MoE experts over ``model`` when E % tp == 0, else TP-inside-expert
  (grok's 8 experts on a 16-way axis);
* decode caches: batch over DP when it divides, otherwise *sequence*
  sharding (context parallelism) — the long_500k cells shard the 500k-token
  KV cache across every mesh axis.

Every proposed axis is divisibility-guarded: a dim that does not divide the
mesh axis is replicated instead.

Placement: an entry shards its dim over the product of its axes,
row-major in the tuple's order (``("data", "model")`` puts the block of
``(i, j)`` at ``i * model + j``), as a JAX ``NamedSharding`` places it;
a dim without axes is whole on every rank.  ``constrain``,
``ambient_mesh`` and ``tp_size`` steer the JAX compiler's placement of
activations and have no counterpart: a trainer on ranks gathers the full
leaves for its forward.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh

__all__ = ["set_layout", "get_layout", "dp_axes", "guard_spec",
           "param_specs", "batch_specs", "cache_specs", "opt_specs",
           "Spec", "flatten", "shard_bytes", "axes_of", "shard_index",
           "shard", "gather"]

#: one entry per dim: None, an axis name, or a tuple of axis names
Entry = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Entry, ...]


def _norm(entry) -> Entry:
    """A spec entry as ``PartitionSpec`` keeps it."""
    if isinstance(entry, tuple):
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


def P(*entries) -> Spec:
    return tuple(_norm(e) for e in entries)


# ---------------------------------------------------------------------------
# layout policy:
#   "tp"    — default: FSDP over 'data' x TP over 'model'
#   "fsdp"  — treat 'model' as extra data parallelism (params sharded over
#             all 256 devices; per-layer all-gather): right for <10B dense
#             models where TP all-reduces dominate
#   "zero1" — params replicated, optimizer state sharded, grads
#             all-reduced: minimum wire volume (~2N bytes/step) when the
#             replicated params + temps fit the device
_LAYOUT = "tp"


def set_layout(layout: str) -> None:
    global _LAYOUT
    if layout not in ("tp", "fsdp", "zero1"):
        raise ValueError(f"unknown layout {layout!r} "
                         f"(expected tp/fsdp/zero1)")
    _LAYOUT = layout


def get_layout() -> str:
    return _LAYOUT


def dp_axes(mesh) -> Tuple[str, ...]:
    base = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    if _LAYOUT in ("fsdp", "zero1") and "model" in mesh.axis_names:
        return base + ("model",)
    return base


def guard_spec(spec, shape, mesh) -> Spec:
    """Replace axes that don't divide the corresponding dim with None."""
    spec = P(*spec)
    out = []
    for dim, ax in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(ax if dim % size == 0 else None)
    return P(*out)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _rule(path: Tuple[str, ...], ndim: int) -> Spec:
    """Base spec (without period prefix) for one param leaf."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""

    if parent == "embed" and name == "table":
        # vocab-parallel (Megatron-style): vocab over 'model', d replicated,
        # which keeps the lm head collective-free and the loss reduction
        # small
        return P("model", None)
    if parent == "lm_head":
        return P(None, "model")
    if name == "scale" or name == "bias" or name == "b":
        return P(None)

    if parent in ("attn", "xattn"):
        if name in ("wq", "wk", "wv"):
            return P("data", "model")
        if name == "wo":
            return P("model", "data")
        return P("model")                       # biases (out-dim sharded)
    if parent == "mlp":
        if name in ("wi", "wg"):
            return P("data", "model")
        if name == "wo":
            return P("model", "data")
        return P(None)
    if parent == "moe":
        if name == "router":
            return P("data", None)
        # EP spec; param_specs falls back to TP-inside-expert when the
        # expert count does not divide the model axis (e.g. grok's 8e@16)
        if name in ("wi", "wg"):
            return P("model", "data", None)
        if name == "wo":
            return P("model", None, "data")
    if parent == "mamba":
        table = {
            "in_proj": P("data", "model"),
            "conv_w": P(None, "model"),
            "conv_b": P("model"),
            "x_proj": P("model", None),
            "dt_proj": P(None, "model"),
            "dt_bias": P("model"),
            "A_log": P("model", None),
            "D": P("model"),
            "out_proj": P("model", "data"),
        }
        return table[name]
    if parent == "mlstm":
        table = {
            "up": P("data", "model"),
            "wq": P("data", "model"),
            "wk": P("data", "model"),
            "wv": P("data", "model"),
            "wi": P("model", None),
            "wf": P("model", None),
            "bi": P(None),
            "bf": P(None),
            "down": P("model", "data"),
            "skip_scale": P("model"),
        }
        return table[name]
    if parent == "slstm":
        table = {
            "wx": P("data", "model"),
            # contraction-dim sharding: fwd psum is a tiny (B, 4d)
            # activation; the weight grad accumulates shard-locally
            "r": P("model", None),
            "b": P(None),
            "out": P("data", "model"),
        }
        return table[name]
    return P(*([None] * ndim))


def _to_fsdp(spec: Spec) -> Spec:
    """Remap a TP-layout spec to pure FSDP: the first sharded dim takes the
    whole pod (('data','model')), everything else replicates."""
    out, used = [], False
    for ax in spec:
        if ax is not None and not used:
            out.append(("data", "model"))
            used = True
        else:
            out.append(None)
    return P(*out)


def param_specs(cfg, params_shape: Mapping[str, Any], mesh
                ) -> Dict[str, Spec]:
    """``{path: spec}`` for a ``{path: leaf}`` of parameters; a leaf under
    ``decoder`` or ``encoder`` is stacked over the periods (its first dim),
    as the JAX package's leaves are.  ``cfg`` is taken for the JAX
    signature; the rules read only the paths and shapes."""
    def one(path: str, leaf) -> Spec:
        names = tuple(path.split("/"))
        in_stack = names[0] in ("decoder", "encoder")
        ndim = leaf.ndim - (1 if in_stack else 0)
        spec = _rule(names, ndim)
        # MoE fallback: if EP can't shard the expert dim (E % tp != 0),
        # use TP-inside-expert so the weights never replicate over 'model'
        if (len(names) >= 2 and names[-2] == "moe"
                and names[-1] in ("wi", "wg", "wo")):
            E = leaf.shape[1] if in_stack else leaf.shape[0]
            if _LAYOUT == "tp" and E % mesh.shape.get("model", 1) != 0:
                spec = (P(None, "data", "model") if names[-1] in ("wi", "wg")
                        else P(None, "model", "data"))
        if _LAYOUT == "fsdp":
            spec = _to_fsdp(spec)
        elif _LAYOUT == "zero1":
            spec = P(*([None] * ndim))            # replicated params
        spec = P(*((None,) + spec)) if in_stack else spec
        return guard_spec(spec, leaf.shape, mesh)

    return {path: one(path, leaf) for path, leaf in params_shape.items()}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(cfg, batch_shape: Mapping[str, Any], mesh
                ) -> Dict[str, Spec]:
    dp = dp_axes(mesh)
    return {k: guard_spec(P(dp, *([None] * (leaf.ndim - 1))), leaf.shape,
                          mesh)
            for k, leaf in batch_shape.items()}


def cache_specs(cfg, cache_shape: Mapping[str, Any], mesh,
                *, seq_shard: bool = False) -> Dict[str, Spec]:
    """Decode-cache specs over the JAX package's cache leaves, stacked over
    the periods: ``{"l0/self/0": (period, B, S, kv, hd), ...}``.
    ``seq_shard=True``: context parallelism — the KV sequence axis is
    sharded across every mesh axis (long_500k, batch=1)."""
    dp = dp_axes(mesh)
    all_axes = tuple(mesh.axis_names)

    def one(path: str, leaf) -> Spec:
        last = path.split("/")[-1]
        if last == "C" and leaf.ndim == 5:           # mLSTM (per,B,H,dh,dh)
            spec = P(None, dp, None, "model", None)
        elif leaf.ndim == 5:                          # KV (per,B,S,kv,hd)
            if seq_shard:
                spec = P(None, None, all_axes, None, None)
            else:
                spec = P(None, dp, "model", None, None)
        elif last == "conv" and leaf.ndim == 4:       # mamba (per,B,K-1,di)
            spec = P(None, dp, None, "model")
        elif last == "n" and leaf.ndim == 4:          # mLSTM (per,B,H,dh)
            spec = P(None, dp, None, "model")
        elif leaf.ndim == 4:                          # mamba ssm (per,B,di,N)
            spec = P(None, dp, "model", None)
        elif leaf.ndim == 3:                          # slstm / mLSTM m
            spec = P(None, dp, "model")
        else:
            spec = P(*([None] * leaf.ndim))
        return guard_spec(spec, leaf.shape, mesh)

    return {path: one(path, leaf) for path, leaf in cache_shape.items()}


def opt_specs(pspecs: Mapping[str, Spec], o_shape: Mapping[str, Any], mesh
              ) -> Dict[str, Spec]:
    """Optimizer slots inherit the parameter spec where shapes match
    (factored Adafactor rows drop the trailing axis).  Under the "zero1"
    layout, slots are instead sharded over the whole pod on their largest
    divisible dim (params stay replicated — ZeRO stage 1).  ``o_shape``'s
    paths are the JAX package's: ``m/<param path>``, ``slots/<param
    path>/vr``, ``count``."""
    if _LAYOUT == "zero1":
        pod = tuple(mesh.axis_names)
        size = 1
        for a in pod:
            size *= mesh.shape[a]

        def z1(leaf) -> Spec:
            dims = [(d, i) for i, d in enumerate(leaf.shape)
                    if d % size == 0]
            if not dims:
                return P(*([None] * leaf.ndim))
            _, best = max(dims)
            spec = [None] * leaf.ndim
            spec[best] = pod
            return P(*spec)

        return {path: z1(leaf) for path, leaf in o_shape.items()}

    flat_p = {tuple(k.split("/")): s for k, s in sorted(pspecs.items())}

    def one(path: str, leaf) -> Spec:
        names = tuple(path.split("/"))
        for k, spec in flat_p.items():
            if names[-len(k) - 1:-1] == k or names[-len(k):] == k:
                if len(spec) == leaf.ndim:
                    return guard_spec(spec, leaf.shape, mesh)
                if len(spec) == leaf.ndim + 1:      # factored slot
                    return guard_spec(spec[:-1], leaf.shape, mesh)
        return P(*([None] * leaf.ndim))

    return {path: one(path, leaf) for path, leaf in o_shape.items()}


# ---------------------------------------------------------------------------
# trees and shard sizes
# ---------------------------------------------------------------------------

def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested tree of dicts, lists and tuples as ``{path: leaf}``, under
    the path names the JAX package's sharding rules read (a list or tuple
    entry by its bare index, where a checkpoint key writes ``[i]``)."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def axes_of(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in its order."""
    return () if entry is None else entry if isinstance(entry, tuple) \
        else (entry,)


def shard_bytes(leaves: Mapping[str, Any], specs: Mapping[str, Spec],
                mesh) -> int:
    """Bytes one device holds of ``leaves`` (tensors, e.g. on ``meta``)
    sharded by ``specs``: each leaf's bytes over the product of the mesh
    axes its dims are sharded on (the specs are divisibility-guarded).
    A rank of a trainer on a mesh holds exactly this many bytes of its
    optimizer state under ``opt_specs`` (its parameters are whole)."""
    total = 0
    for path, leaf in leaves.items():
        parts = 1
        for ax in specs[path]:
            for a in axes_of(ax):
                parts *= mesh.shape[a]
        total += leaf.numel() * leaf.element_size() // parts
    return total


# ---------------------------------------------------------------------------
# placement on a mesh of ranks
# ---------------------------------------------------------------------------

def shard_index(spec, shape, mesh, coord: Sequence[int]
                ) -> Tuple[slice, ...]:
    """The slices of a leaf of ``shape`` that the device at mesh
    coordinate ``coord`` (one index per ``mesh.axis_names``) holds under
    ``spec``: ``slice(None)`` for a whole dim (no axes, or axes of size
    1), else its block, the blocks
    numbered row-major over the entry's axes in their order.  Equal to
    JAX's ``NamedSharding(mesh, spec).devices_indices_map(shape)`` for
    that device.  A dim that its axes do not divide raises (the rules'
    specs are guarded)."""
    spec = P(*spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    at = dict(zip(mesh.axis_names, coord))
    out = []
    for dim, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        axes = axes_of(entry)
        if not axes:
            out.append(slice(None))
            continue
        parts, pos = 1, 0
        for a in axes:
            parts *= mesh.shape[a]
            pos = pos * mesh.shape[a] + at[a]
        if parts == 1:
            out.append(slice(None))
            continue
        if dim % parts:
            raise ValueError(f"dim {dim} does not divide over {axes} "
                             f"({parts} parts)")
        size = dim // parts
        out.append(slice(pos * size, (pos + 1) * size))
    return tuple(out)


def shard(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec`` on ``mesh`` (a
    ``DeviceMesh``), as a tensor of its own."""
    idx = shard_index(spec, full.shape, Mesh.of(mesh), mesh.get_coordinate())
    return full[idx].clone(memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, spec, shape, mesh) -> torch.Tensor:
    """The full leaf of ``shape`` from each rank's slice ``local`` under
    ``spec``: for each dim, ``all_gather_into_tensor`` over each of its
    axes' groups on ``mesh`` (a ``DeviceMesh``), the last axis of an entry
    first, so the blocks come together in the spec's order.  A spec that
    names no axis returns ``local`` itself."""
    spec = P(*spec)
    out = local
    for d, entry in enumerate(spec):
        for a in reversed(axes_of(entry)):
            group = mesh.get_group(a)
            n = dist.get_world_size(group)
            out = out.contiguous()
            shp = tuple(out.shape)
            buf = out.new_empty((n * shp[0],) + shp[1:])
            dist.all_gather_into_tensor(buf, out, group=group)
            if d:
                buf = buf.reshape((n,) + shp).movedim(0, d).reshape(
                    shp[:d] + (n * shp[d],) + shp[d + 1:])
            out = buf
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"gathered {tuple(out.shape)}, expected "
                         f"{tuple(shape)}")
    return out
