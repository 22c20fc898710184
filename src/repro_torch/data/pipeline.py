"""Deterministic synthetic LM data pipeline.

The port of ``repro/data/pipeline.py``.  Stateless: batch ``i`` is a pure
function of (seed, i), so a restarted trainer resumes mid-stream without
data loss or duplication.  Tokens follow a Zipf-ish distribution with
injected local structure (skip-gram copies) so the loss has signal to
descend.  The batches are numpy, drawn exactly as the JAX package draws
them, so both packages see the same tokens bit for bit.

``to_device`` takes the place of ``make_global_batch``: on one card there
is no mesh to shard over, only a copy of the int32 arrays to the device.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.execution import resolve_device

__all__ = ["SyntheticLM", "to_device"]


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
