"""Deterministic synthetic LM data pipeline.

The port of ``repro/data/pipeline.py``.  Stateless: batch ``i`` is a pure
function of (seed, i), so a restarted trainer resumes mid-stream without
data loss or duplication.  Tokens follow a Zipf-ish distribution with
injected local structure (skip-gram copies) so the loss has signal to
descend.  The batches are numpy, drawn exactly as the JAX package draws
them, so both packages see the same tokens bit for bit.

On one card ``to_device`` copies the int32 arrays to the device; on a
mesh of ranks ``make_global_batch`` gives each rank its rows of the host
batch (every rank draws the same host batch).
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping

import numpy as np
import torch

from repro_torch.core.execution import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models.sharding import shard_index

__all__ = ["SyntheticLM", "to_device", "make_global_batch"]


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, structure: float = 0.5):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.structure = structure

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S, V = self.global_batch, self.seq_len, self.vocab
        # Zipf-ish marginals
        u = rng.random((B, S + 1))
        toks = np.minimum((u ** 3 * V).astype(np.int64), V - 1)
        # local structure: with prob `structure`, copy the token 2 back
        # (sequential, so copy chains persist and the skip-gram signal is
        # exactly `structure` at every position)
        if S + 1 >= 3:
            copy = rng.random((B, S - 1)) < self.structure
            for j in range(2, S + 1):
                m = copy[:, j - 2]
                toks[m, j] = toks[m, j - 2]
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def to_device(batch: Dict[str, np.ndarray], device=None
              ) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (``None``: the card), each
    keeping its dtype."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def make_global_batch(batch: Dict[str, np.ndarray], mesh, specs: Mapping,
                      device=None) -> Dict[str, torch.Tensor]:
    """This rank's part of a host batch on a mesh of ranks (a
    ``DeviceMesh``): each array's slice under its spec (``batch_specs``)
    at this rank's mesh coordinate, as a tensor on ``device`` (``None``:
    the card).  Rows are whole on every rank where the spec replicates
    them (a global batch that the data axes do not divide)."""
    dev = resolve_device(device)
    view, coord = Mesh.of(mesh), mesh.get_coordinate()
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[shard_index(specs[k], v.shape, view, coord)])).to(dev)
        for k, v in batch.items()}
