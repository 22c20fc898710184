"""Fault-tolerant checkpointing (save / restore / resume).

The port of ``repro/train/checkpoint.py``, in the JAX package's on-disk
format, so a checkpoint written by either package restores in the other:

* a checkpoint is a directory ``step_<N>/`` holding ``arrays.npz`` and a
  ``manifest.json`` (step, time, the sorted keys, ``extra``);
* the keys are the JAX package's pytree paths: a dict key as itself, a
  tuple or list index as ``[i]``, joined by ``/`` (``[0]/embed/table``,
  ``[1]/m/decoder/l0_mix/attn/wq``, ``[1]/count``), dict keys in sorted
  order;
* writes are atomic: ``step_<N>.tmp`` -> fsync -> rename, so a crash
  mid-write never corrupts the latest checkpoint; ``latest_step`` skips
  ``.tmp`` directories and directories without a manifest;
* a retention policy keeps the newest ``keep`` checkpoints;
* on a mesh of ranks the arrays are the logical (full) leaves: one rank
  writes (``CheckpointManager(writer=)``) and every rank waits at the
  manager's ``barrier`` before any reads ``latest_step``; every rank
  restores the logical arrays and keeps its own slice, so a checkpoint
  resumes on any mesh (the elastic restore) or on one device.

A tree here is nested dicts, tuples and lists whose leaves are tensors or
numpy arrays.  bfloat16 has no numpy dtype: the JAX package's bfloat16
arrays come back from ``np.load`` as raw two-byte records (``|V2``), so
the port writes its bfloat16 tensors as the same records (the same bytes)
and reads such a record array into a bfloat16 tensor.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.interop import from_numpy, to_numpy

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager", "flatten"]

def _items(node):
    """The children of an inner node with their path segments, in the
    JAX package's order (dict keys sorted, sequences in order)."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return [(f"[{i}]", v) for i, v in enumerate(node)]


def _is_inner(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def flatten(tree, prefix="") -> Dict[str, Any]:
    """The leaves of ``tree`` by their checkpoint keys."""
    flat = {}
    for seg, child in _items(tree):
        key = f"{prefix}/{seg}" if prefix else seg
        if _is_inner(child):
            flat.update(flatten(child, key))
        else:
            flat[key] = child
    return flat


def _unflatten_into(tree_like, flat: Dict[str, np.ndarray], prefix=""):
    out = {} if isinstance(tree_like, dict) else []
    for seg, like in _items(tree_like):
        key = f"{prefix}/{seg}" if prefix else seg
        if _is_inner(like):
            val = _unflatten_into(like, flat, key)
        else:
            arr = flat[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{key}: ckpt shape {arr.shape} != "
                                 f"{tuple(like.shape)}")
            val = from_numpy(arr, like)
        if isinstance(out, dict):
            out[seg] = val
        else:
            out.append(val)
    return tuple(out) if isinstance(tree_like, tuple) else out


def save_checkpoint(directory: str, step: int, tree, *,
                    extra: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: to_numpy(v) for k, v in flatten(tree).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": int(step),
        "time": time.time(),
        "keys": sorted(flat),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _valid(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json"))


def _steps(directory: str, valid_only: bool):
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if valid_only and not _valid(os.path.join(directory, name)):
                continue
            if name[5:].isdigit():
                steps.append(int(name[5:]))
    return steps


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory, valid_only=True)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, tree_like):
    """``(tree, manifest)``: the checkpoint's arrays as CPU tensors in the
    structure of ``tree_like``, whose leaves give the shapes (and, where
    they are tensors, the dtypes) to expect.  A mismatch raises
    ``ValueError``."""
    path = os.path.join(directory, f"step_{step}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten_into(tree_like, flat)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return tree, manifest


class CheckpointManager:
    """Periodic save + retention + resume (the trainer's FT backbone).
    On a mesh of ranks only the ``writer`` writes, and every rank calls
    ``barrier`` after a save."""

    def __init__(self, directory: str, *, every: int = 50, keep: int = 3,
                 writer: bool = True,
                 barrier: Optional[Callable[[], Any]] = None):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.writer = writer
        self.barrier = barrier

    def maybe_save(self, step: int, tree, *, extra=None, force=False):
        """Save ``tree`` (or what the function ``tree`` returns, called
        only when a checkpoint is due) as step ``step`` every ``every``
        steps, or now with ``force``; returns the path (``None`` when
        nothing was written here)."""
        if not force and (step == 0 or step % self.every != 0):
            return None
        if callable(tree):
            tree = tree()
        path = None
        if self.writer:
            path = save_checkpoint(self.directory, step, tree, extra=extra)
            self._retain()
        if self.barrier is not None:
            self.barrier()
        return path

    def _retain(self):
        for s in sorted(_steps(self.directory, valid_only=False))[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def resume(self, tree_like):
        """(tree, step) from the latest valid checkpoint, or (None, 0)."""
        step = latest_step(self.directory)
        if step is None:
            return None, 0
        tree, _ = restore_checkpoint(self.directory, step, tree_like)
        return tree, step
