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
           "tensor_from_array", "sellcs_from_arrays", "state_from_arrays",
           "model_from_arrays"]

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


def tensor_from_array(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``.  A bfloat16 array (numpy
    has no bfloat16 of its own) crosses bit for bit through int16."""
    a = np.array(a, order="C")               # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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
