"""Device resolution and kernel launch counters.

The JAX package's ``core/execution.py`` chooses between compiled and
interpreted Pallas and falls back to the reference when a kernel fails.
The port has no such policy: entry points run on the card unless the
caller names the CPU, a kernel wrapper given CUDA tensors launches its
kernel or raises, and the plain PyTorch version runs only for CPU tensors
or when a caller asks for ``impl="ref"``.

What stays is bookkeeping: every kernel wrapper adds one to its launch
counter at the point where it launches, so a run can show that its main
path went through the kernels (``chip_smoke.py`` reads the counters).
``solvers/stepper.run_chunk`` enqueues one iteration ahead of its
stopping test and counts each iteration it then drops, by solver name, so
launches per solve are ``(iterations + discarded) * per-iteration + init``.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

__all__ = ["resolve_device", "canonical_device", "count_launch",
           "launch_counts", "reset_launch_counts", "count_discarded",
           "discarded_counts"]

_launches: Dict[str, int] = {}
_discarded: Dict[str, int] = {}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller asks for the CPU explicitly (device='cpu')")
    return dev


def canonical_device(device: Optional[Union[str, torch.device]] = None
                     ) -> torch.device:
    """:func:`resolve_device` with the card's index filled in (``"cuda"``
    becomes the current card), so devices compare equal by value."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper)."""
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    """A copy of the launch counters, by kernel name."""
    return dict(_launches)


def count_discarded(name: str) -> None:
    """Record one solver iteration of ``name`` that ``run_chunk`` enqueued
    and then dropped (every column was already done)."""
    _discarded[name] = _discarded.get(name, 0) + 1


def discarded_counts() -> Dict[str, int]:
    """A copy of the discarded-iteration counters, by solver name."""
    return dict(_discarded)


def reset_launch_counts() -> None:
    """Set every launch counter and discarded-iteration counter to 0."""
    for name in _launches:
        _launches[name] = 0
    for name in _discarded:
        _discarded[name] = 0
