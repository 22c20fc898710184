"""Shared machinery for resumable stepper-form Krylov solvers.

Each solver factors into ``*_init(op, b, x0) -> State``,
``*_step(op, state, k) -> State`` and ``*_finalize(state) -> Result``.
A *State* is a NamedTuple whose per-column fields carry the block-vector
column as their **last** axis (``(n, b)`` vectors, ``(b,)`` recurrence
scalars, ``(b,)`` bool ``done``) plus scalar bookkeeping (``it``,
``maxiter``, Python ints).  :func:`merge_columns` can splice freshly
initialized columns into a running state without touching the survivors.

``*_step`` runs up to ``k`` applications of the *same* iteration body the
monolithic solver uses, stopping early at ``maxiter`` or when every
column has converged — the stopping test of the JAX package's bounded
``while_loop``.  Composing chunks is therefore bit-identical to one
monolithic solve.  The loop is plain Python and reads ``done`` on the
host once per iteration.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["run_chunk", "merge_columns", "merge_columns_masked",
           "snap_chunk", "clear_chunk_cache"]


def run_chunk(op, name: str, k: int, state, body: Callable, *args):
    """Advance ``state`` by up to ``k`` iterations of
    ``body(op, *args, state)``.

    The loop stops early once ``state.it`` reaches ``state.maxiter`` or
    every column's ``done`` flag is set — exactly the monolithic solver's
    termination test, so chunking never changes the iterate sequence.
    ``name`` labels the solver, as in the JAX package, where it keys the
    cache of compiled chunks.  ``args`` (a preconditioner) are handed to
    ``body`` rather than captured by a closure.
    """
    i = 0
    k = int(k)
    while i < k and state.it < state.maxiter and not bool(state.done.all()):
        state = body(op, *args, state)
        i += 1
    return state


def snap_chunk(k, k_max: int) -> int:
    """Clamp a desired chunk length to ``[1, k_max]``, snapped down to a
    power of two, so a scheduler that derives ``k`` from a continuous
    quantity asks for a bounded family of chunk lengths."""
    k_max = int(k_max)
    if k_max < 1:
        raise ValueError(f"k_max must be >= 1, got {k_max}")
    k = int(k)
    if k >= k_max:
        return k_max
    if k < 1:
        return 1
    return 1 << (k.bit_length() - 1)


def merge_columns_masked(old_state, fresh_state, mask):
    """:func:`merge_columns` with the selection as a ``(b,)`` bool mask.

    Block-Krylov states (``BLOCK_COUPLED``) cannot be column-spliced:
    their carried ``(b, b)`` blocks couple every column.
    """
    if getattr(old_state, "BLOCK_COUPLED", False):
        raise ValueError(
            f"{type(old_state).__name__} carries cross-column (b, b) "
            f"blocks and cannot be column-spliced; refill block-Krylov "
            f"batches with a warm restart (re-init with carried x0)")
    mask = torch.as_tensor(mask, dtype=torch.bool,
                           device=old_state.done.device)

    def pick(old, fresh):
        if not isinstance(old, torch.Tensor) or old.ndim == 0:
            return old
        sel = mask if old.ndim == 1 else mask[None, :]
        return torch.where(sel, fresh, old)

    return type(old_state)(*(pick(o, f) for o, f in zip(old_state,
                                                        fresh_state)))


def merge_columns(old_state, fresh_state, cols):
    """Splice columns ``cols`` of ``fresh_state`` into ``old_state``.

    Per-column fields take the fresh values at ``cols``; scalar
    bookkeeping (``it``, ``maxiter``) keeps the running values.
    """
    width = old_state.done.shape[0]
    mask = np.zeros(width, bool)
    mask[list(cols)] = True
    return merge_columns_masked(old_state, fresh_state, mask)


def clear_chunk_cache() -> None:
    """Drop cached chunks.  The port compiles no chunks (its loop is plain
    Python), so there is nothing to drop; the name is kept so callers of
    the JAX package's API run unchanged."""
