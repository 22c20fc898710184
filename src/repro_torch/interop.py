"""Carry the JAX package's matrices, solver states and model weights into
the port.

The port's counterpart of loading weights: the arrays of a matrix, a
solver state or an LM's parameter tree built by the JAX package, handed
over as numpy arrays, become the port's tensors on ``device``, so both
packages can be held to the same inputs.  Nothing here imports the JAX package; the caller converts with
``np.asarray`` on its side.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.execution import resolve_device
from repro_torch.core.sellcs import SellCS
from repro_torch.models.layers import params
from repro_torch.models.transformer import (Model, ModelConfig,
                                            n_enc_periods)
from repro_torch.solvers.block import BlockCGState, BlockMinresState
from repro_torch.solvers.cg import CGState, PrecondCGState
from repro_torch.solvers.minres import MinresState, PrecondMinresState

__all__ = ["SELLCS_ARRAYS", "SELLCS_META", "CGSTATE_ARRAYS", "STATE_TYPES",
           "RAW_BF16", "to_numpy", "from_numpy", "tensor_from_array",
           "sellcs_from_arrays", "state_from_arrays", "model_from_arrays",
           "leaf_groups", "nest", "arrays_from_model"]

#: the eight array fields of a SELL-C-sigma matrix, in both packages
SELLCS_ARRAYS = ("vals", "cols", "chunk_off", "chunk_len", "rowids",
                 "row_len", "perm", "iperm")
#: its static fields
SELLCS_META = ("C", "sigma", "nrows", "ncols", "nnz", "w_align",
               "permuted_cols", "compute_dtype")
#: the stepper states that cross over, and their integer fields
STATE_TYPES = (CGState, MinresState, BlockCGState, BlockMinresState,
               PrecondCGState, PrecondMinresState)
_INT_FIELDS = ("it", "maxiter")
#: the tensor fields of a CG state (``it`` and ``maxiter`` are ints)
CGSTATE_ARRAYS = tuple(f for f in CGState._fields if f not in _INT_FIELDS)


#: the numpy dtype of a bfloat16 array read back from an ``.npz``
RAW_BF16 = np.dtype("V2")


def to_numpy(leaf) -> np.ndarray:
    """A tensor or array as a numpy array: a bfloat16 tensor (numpy has no
    bfloat16 of its own) as raw two-byte records (``|V2``) holding its
    bytes, the form in which a JAX bfloat16 array comes back from an
    ``.npz``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(RAW_BF16)
        return t.numpy()
    return np.asarray(leaf)


def from_numpy(arr: np.ndarray, like=None) -> torch.Tensor:
    """A CPU tensor of a copy of ``arr``; raw two-byte records become
    bfloat16.  With ``like`` (a tensor), the dtypes must agree."""
    arr = np.array(arr, order="C")          # a writable copy
    if arr.dtype == RAW_BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor) and t.dtype != like.dtype:
        raise ValueError(f"dtype {t.dtype} != {like.dtype}")
    return t


def tensor_from_array(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``.  A bfloat16 array (numpy
    has no bfloat16 of its own) crosses bit for bit through int16; so
    does an array of raw two-byte records (``|V2``), the form in which a
    bfloat16 array comes back from an ``.npz`` and in which
    :func:`arrays_from_model` hands bfloat16 weights out."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(RAW_BF16)
    return from_numpy(a).to(device)


def sellcs_from_arrays(arrays: Mapping[str, np.ndarray],
                       meta: Mapping[str, object], device=None) -> SellCS:
    """A port :class:`SellCS` from the JAX package's arrays and static
    fields (``{f: np.asarray(getattr(A, f))}`` and ``{f: getattr(A, f)}``).
    ``device=None`` means the card."""
    dev = resolve_device(device)
    missing = [f for f in SELLCS_ARRAYS if f not in arrays]
    missing += [f for f in SELLCS_META if f not in meta]
    if missing:
        raise ValueError(f"sellcs_from_arrays: missing fields {missing}")
    tensors = {f: tensor_from_array(arrays[f], dev) for f in SELLCS_ARRAYS}
    for f in SELLCS_ARRAYS[1:]:
        if tensors[f].dtype != torch.int32:
            raise TypeError(f"sellcs_from_arrays: {f} must be int32, "
                            f"got {tensors[f].dtype}")
    cd = meta["compute_dtype"]
    return SellCS(**tensors,
                  C=int(meta["C"]), sigma=int(meta["sigma"]),
                  nrows=int(meta["nrows"]), ncols=int(meta["ncols"]),
                  nnz=int(meta["nnz"]), w_align=int(meta["w_align"]),
                  permuted_cols=bool(meta["permuted_cols"]),
                  compute_dtype=None if cd is None else str(cd))


def _best_state_type(names) -> type:
    """The stepper state whose fields ``names`` hold (the one with the most
    fields when several fit); :class:`CGState` when none does."""
    fits = [t for t in STATE_TYPES if set(t._fields) <= set(names)]
    return max(fits, key=lambda t: len(t._fields)) if fits else CGState


def state_from_arrays(arrays: Mapping[str, object], device=None):
    """A port stepper state from the JAX package's state fields
    (``{f: np.asarray(getattr(state, f))}``): a :class:`CGState`,
    :class:`MinresState`, :class:`BlockCGState`, :class:`BlockMinresState`,
    :class:`PrecondCGState` or :class:`PrecondMinresState`, recognised by
    its field names (a preconditioned state's fields include its plain
    counterpart's, and the type with the most fields wins).
    ``device=None`` means the card."""
    dev = resolve_device(device)
    st = _best_state_type(arrays)
    missing = [f for f in st._fields if f not in arrays]
    if missing:
        raise ValueError(f"state_from_arrays: missing fields {missing}")
    return st(**{f: (int(arrays[f]) if f in _INT_FIELDS
                     else tensor_from_array(arrays[f], dev))
                 for f in st._fields})


def _module(tree: Mapping[str, Any], dev, period=None):
    """A nested dict of arrays as nested ``ModuleDict``s whose leaves are
    ``ParameterDict``s; ``period`` picks one slice of arrays stacked over
    periods."""
    if all(not isinstance(v, Mapping) for v in tree.values()):
        return params(**{k: tensor_from_array(
            v if period is None else np.asarray(v)[period], dev)
            for k, v in tree.items()})
    return torch.nn.ModuleDict({k: _module(v, dev, period)
                                for k, v in tree.items()})


def _leaves(tree: Mapping[str, Any]):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from _leaves(v)
        else:
            yield v


def model_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any],
                      device=None) -> Model:
    """A port :class:`Model` from the JAX package's parameter pytree
    (``jax.tree.map(np.asarray, params)``).  The decoder's arrays are
    stacked over the pattern's periods under ``decoder/l{i}_mix`` and
    ``decoder/l{i}_ffn``; each period becomes one entry of
    ``Model.decoder``.  An encoder-decoder model's ``encoder`` is stacked
    the same way over its own periods, beside ``enc_norm``.  Each leaf
    keeps its dtype (xLSTM's gate weights are float32 beside bfloat16
    projections).  ``device=None`` means the card."""
    dev = resolve_device(device)
    want = {f"l{i}_{part}" for i in range(cfg.period)
            for part in ("mix", "ffn")}

    def stack(name, n_periods):
        got = tree[name]
        if set(got) != want:
            raise ValueError(f"model_from_arrays: {name} entries "
                             f"{sorted(got)} do not match the pattern's "
                             f"{sorted(want)}")
        have = {np.shape(leaf)[0] for leaf in _leaves(got)}
        if have != {n_periods}:
            raise ValueError(f"model_from_arrays: {sorted(have)} periods of "
                             f"{name} weights for {n_periods} in the config")
        return [{k: _module(v, dev, period) for k, v in got.items()}
                for period in range(n_periods)]

    out = {"embed": _module(tree["embed"], dev),
           "final_norm": _module(tree["final_norm"], dev),
           "decoder": stack("decoder", cfg.n_periods)}
    if cfg.enc_dec:
        out["encoder"] = stack("encoder", n_enc_periods(cfg))
        out["enc_norm"] = _module(tree["enc_norm"], dev)
    if "lm_head" in tree:
        out["lm_head"] = _module(tree["lm_head"], dev)
    return Model(cfg, out)


def leaf_groups(model: Model):
    """The model's parameters grouped by the JAX package's tree paths, in
    sorted order: ``[(path, parameters, stacked)]``.  A decoder (encoder)
    weight is one path (``decoder/l0_mix/attn/wq``) holding that weight
    of every period, in order, to be stacked on axis 0 (``stacked``); any
    other weight is a path of its own (``embed/table``)."""
    groups = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        stacked = parts[0] in ("decoder", "encoder")
        key = "/".join(parts[:1] + parts[2:] if stacked else parts)
        groups.setdefault(key, (stacked, []))[1].append(p)
    return [(k, groups[k][1], groups[k][0]) for k in sorted(groups)]


def nest(keys, values) -> dict:
    """``{"a/b": v}`` as ``{"a": {"b": v}}``."""
    tree: dict = {}
    for k, v in zip(keys, values):
        node = tree
        *path, last = k.split("/")
        for seg in path:
            node = node.setdefault(seg, {})
        node[last] = v
    return tree


def arrays_from_model(model: Model) -> dict:
    """The inverse of :func:`model_from_arrays`: the JAX package's
    parameter tree (:func:`leaf_groups`' paths) as nested dicts of numpy
    arrays, each period's weights stacked on axis 0 under ``decoder``
    (and ``encoder``).  A bfloat16 weight comes out as raw two-byte
    records (:func:`to_numpy`); view it as ``ml_dtypes.bfloat16`` on the
    JAX side."""
    groups = leaf_groups(model)
    return nest([k for k, _, _ in groups],
                [to_numpy(torch.stack(ps) if stacked else ps[0])
                 for _, ps, stacked in groups])
