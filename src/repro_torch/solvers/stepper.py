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
monolithic solve.  The loop is plain Python.  It reads each iteration's
``done`` one iteration late: iteration i+1 is enqueued before iteration
i's flag reaches the host, so the card never drains while Python enqueues
the next iteration's launches.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import execution

__all__ = ["run_chunk", "merge_columns", "merge_columns_masked",
           "snap_chunk", "clear_chunk_cache"]


def _post_all_done(done: torch.Tensor, host):
    """Start reading ``done.all()`` without waiting for the card: the flag
    goes into ``host`` (a pinned host scalar) by a non-blocking copy, with
    an event recorded after it.  On the CPU (``host`` None) the flag is
    already on the host."""
    flag = done.all()
    if host is None:
        return flag, None
    host.copy_(flag, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(flag.device))
    return host, event


def _all_done(posted) -> bool:
    """The flag :func:`_post_all_done` started; waits for its event only."""
    host, event = posted
    if event is not None:
        event.synchronize()
    return bool(host)


def run_chunk(op, name: str, k: int, state, body: Callable, *args):
    """Advance ``state`` by up to ``k`` iterations of
    ``body(op, *args, state)``.

    The loop stops early once ``state.it`` reaches ``state.maxiter`` or
    every column's ``done`` flag is set — exactly the monolithic solver's
    termination test, so chunking never changes the iterate sequence.
    ``name`` labels the solver, as in the JAX package, where it keys the
    cache of compiled chunks.  ``args`` (a preconditioner) are handed to
    ``body`` rather than captured by a closure.

    The test on ``done`` is read one iteration late: the body of
    iteration i+1 is enqueued before iteration i's flag is read, so the
    host waits only for that flag while the card already runs the next
    iteration.  When the flag says every column is done, state i is
    returned and the speculative state i+1 is dropped (bodies are
    functional, so nothing else changed), and
    ``execution.count_discarded(name)`` records it: at most one per call.
    ``k`` and ``maxiter`` are host integers, so the loop never enqueues an
    iteration past either of them.
    """
    k = int(k)
    if k <= 0 or state.it >= state.maxiter:
        return state
    # two pinned slots: iteration i's flag is read before slot i % 2 is
    # written again
    slots = (tuple(torch.empty((), dtype=torch.bool, pin_memory=True)
                   for _ in range(2))
             if state.done.device.type == "cuda" else (None, None))
    i = 0
    posted = _post_all_done(state.done, slots[0])
    while True:
        nxt = body(op, *args, state)
        more = i + 1 < k and nxt.it < nxt.maxiter
        nxt_posted = (_post_all_done(nxt.done, slots[(i + 1) % 2]) if more
                      else None)
        if _all_done(posted):
            execution.count_discarded(name)
            return state
        state, i = nxt, i + 1
        if not more:
            return state
        posted = nxt_posted


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
