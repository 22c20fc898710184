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
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

__all__ = ["resolve_device", "count_launch", "launch_counts",
           "reset_launch_counts"]

_launches: Dict[str, int] = {}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller asks for the CPU explicitly (device='cpu')")
    return dev


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper)."""
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    """A copy of the launch counters, by kernel name."""
    return dict(_launches)


def reset_launch_counts() -> None:
    """Set every launch counter to 0."""
    for name in _launches:
        _launches[name] = 0
