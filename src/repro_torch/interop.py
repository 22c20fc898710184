"""Carry the JAX package's matrices and solver states into the port.

The port's counterpart of loading weights: the arrays of a matrix (or a
solver state) built by the JAX package, handed over as numpy arrays, become
the port's tensors on ``device``, so both packages can be held to the same
inputs.  Nothing here imports the JAX package; the caller converts with
``np.asarray`` on its side.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.execution import resolve_device
from repro_torch.core.sellcs import SellCS
from repro_torch.solvers.block import BlockCGState, BlockMinresState
from repro_torch.solvers.cg import CGState, PrecondCGState
from repro_torch.solvers.minres import MinresState, PrecondMinresState

__all__ = ["SELLCS_ARRAYS", "SELLCS_META", "CGSTATE_ARRAYS", "STATE_TYPES",
           "tensor_from_array", "sellcs_from_arrays", "state_from_arrays"]

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
