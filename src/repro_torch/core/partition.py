"""Work distribution & permutations (paper C4, sections 3.1 / 4.1).

A numpy-only copy of ``repro.core.partition``: the port partitions
without importing the JAX package, and the parity tests hold every
function's output identical to the reference's.

* Weighted row-wise partitioning: processes (devices) receive a share of
  rows or nonzeros proportional to a per-device *weight* (GHOST uses
  attainable memory bandwidth; the heterogeneous engine starts from the
  device pool's roofline weights and refines them from measured times).
* Bandwidth reduction: built-in reverse Cuthill-McKee (replaces PT-SCOTCH's
  role of communication minimization, section 3.1).
* Greedy row coloring (replaces ColPack; for Kaczmarz / Gauss-Seidel).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "weighted_row_partition",
    "weighted_nnz_partition",
    "apportioned_row_partition",
    "apportioned_nnz_partition",
    "rcm_permutation",
    "greedy_coloring",
    "bandwidth",
]


def weighted_row_partition(
    nrows: int, weights: Sequence[float], *, align: int = 1
) -> List[Tuple[int, int]]:
    """Split ``nrows`` into contiguous ranges proportional to ``weights``.

    Returns [(start, end)) per process.  ``align`` rounds boundaries to a
    multiple (e.g. the SELL chunk height C) so each local part chunks
    cleanly.
    """
    w = np.asarray(weights, np.float64)
    if (w <= 0).any():
        raise ValueError("weights must be positive")
    cum = np.cumsum(w) / w.sum()
    bounds = [0]
    for f in cum[:-1]:
        b = int(round(f * nrows / align)) * align
        b = min(max(b, bounds[-1]), nrows)
        bounds.append(b)
    bounds.append(nrows)
    return [(bounds[i], bounds[i + 1]) for i in range(len(w))]


def weighted_nnz_partition(
    rowlen: np.ndarray, weights: Sequence[float], *, align: int = 1
) -> List[Tuple[int, int]]:
    """Like :func:`weighted_row_partition` but balances *nonzeros* (the
    paper's alternative criterion)."""
    w = np.asarray(weights, np.float64)
    rl = np.asarray(rowlen, np.float64)
    nrows = len(rl)
    total = rl.sum()
    targets = np.cumsum(w / w.sum()) * total
    cs = np.cumsum(rl)
    bounds = [0]
    for t in targets[:-1]:
        b = int(np.searchsorted(cs, t))
        b = (b // align) * align
        b = min(max(b, bounds[-1]), nrows)
        bounds.append(b)
    bounds.append(nrows)
    return [(bounds[i], bounds[i + 1]) for i in range(len(w))]


# --------------------------------------------------------------------------
# Apportionment partitions (used by the heterogeneous runtime).
#
# The cumsum-rounding partitions above are fine for near-uniform weights but
# can emit *empty* shards for strongly skewed weights and leave the final
# boundary unaligned.  The heterogeneous engine needs every device to own a
# non-empty, C-aligned row block (an empty shard would have no rows to
# run), so these variants apportion whole
# ``align``-row blocks by largest remainder (Hamilton's method) and
# guarantee at least one block per shard whenever enough blocks exist.
# --------------------------------------------------------------------------

def _steal_for_empty(cnt: np.ndarray, nblocks: int) -> np.ndarray:
    """Steal blocks from the largest shards until nobody is empty
    (possible only when there are at least as many blocks as shards)."""
    if nblocks >= len(cnt):
        while (cnt == 0).any():
            cnt[int(np.argmax(cnt == 0))] += 1
            cnt[int(np.argmax(cnt))] -= 1
    return cnt


def _apportion_blocks(shares: np.ndarray, nblocks: int) -> np.ndarray:
    """Integer block counts per shard: largest-remainder on ``shares``
    (positive, sum-normalized), each shard >= 1 block if nblocks >= nshards."""
    ideal = shares / shares.sum() * nblocks
    cnt = np.floor(ideal).astype(np.int64)
    rem = nblocks - int(cnt.sum())
    if rem > 0:
        order = np.argsort(-(ideal - cnt), kind="stable")
        cnt[order[:rem]] += 1
    return _steal_for_empty(cnt, nblocks)


def _counts_to_ranges(cnt: np.ndarray, align: int, nrows: int):
    bounds = np.concatenate([[0], np.cumsum(cnt)]) * align
    bounds = np.minimum(bounds, nrows)
    bounds[-1] = nrows
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(len(cnt))]


def apportioned_row_partition(
    nrows: int, weights: Sequence[float], *, align: int = 1
) -> List[Tuple[int, int]]:
    """Weight-proportional contiguous row ranges via block apportionment.

    Like :func:`weighted_row_partition` but boundaries are exact multiples
    of ``align`` (only the final boundary may be the unaligned ``nrows``)
    and no shard is empty as long as ``nrows >= nshards * align``.
    """
    w = np.asarray(weights, np.float64)
    if (w <= 0).any():
        raise ValueError("weights must be positive")
    nblocks = (nrows + align - 1) // align
    cnt = _apportion_blocks(w, nblocks)
    return _counts_to_ranges(cnt, align, nrows)


def apportioned_nnz_partition(
    rowlen: np.ndarray, weights: Sequence[float], *, align: int = 1
) -> List[Tuple[int, int]]:
    """Nonzero-proportional variant: apportions ``align``-row blocks so each
    shard's *nnz* share tracks its weight (GHOST's bandwidth-weighted
    criterion, section 4.1), boundaries aligned, shards non-empty."""
    w = np.asarray(weights, np.float64)
    if (w <= 0).any():
        raise ValueError("weights must be positive")
    rl = np.asarray(rowlen, np.float64)
    nrows = len(rl)
    nblocks = (nrows + align - 1) // align
    # nnz per block (the last, partial block included)
    pad = nblocks * align - nrows
    blk = np.concatenate([rl, np.zeros(pad)]).reshape(nblocks, align).sum(1)
    cs_blk = np.concatenate([[0.0], np.cumsum(blk)])
    total = cs_blk[-1]
    if total <= 0:
        return apportioned_row_partition(nrows, weights, align=align)
    # walk block boundaries to hit cumulative nnz targets, then fix empties
    targets = np.cumsum(w / w.sum()) * total
    bounds = np.searchsorted(cs_blk, targets[:-1], side="left")
    bounds = np.concatenate([[0], bounds, [nblocks]])
    bounds = np.maximum.accumulate(np.clip(bounds, 0, nblocks))
    cnt = _steal_for_empty(np.diff(bounds).astype(np.int64), nblocks)
    return _counts_to_ranges(cnt, align, nrows)


# --------------------------------------------------------------------------
def _adjacency(rows: np.ndarray, cols: np.ndarray, n: int):
    """CSR adjacency of the symmetrized pattern (host-side)."""
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    keep = r != c
    r, c = r[keep], c[keep]
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    if r.size:
        dup = np.zeros(r.size, bool)
        dup[1:] = (r[1:] == r[:-1]) & (c[1:] == c[:-1])
        r, c = r[~dup], c[~dup]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, c


def rcm_permutation(rows, cols, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrized pattern.

    Returns ``perm`` with ``perm[new] = old``.  BFS from a minimum-degree
    node of each connected component, neighbors visited by increasing
    degree; final order reversed.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    indptr, adj = _adjacency(rows, cols, n)
    deg = np.diff(indptr)
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    node_order = np.argsort(deg, kind="stable")
    for seed in node_order:
        if visited[seed]:
            continue
        # BFS
        visited[seed] = True
        queue = [seed]
        qi = 0
        while qi < len(queue):
            u = queue[qi]
            qi += 1
            order[pos] = u
            pos += 1
            nbrs = adj[indptr[u]:indptr[u + 1]]
            nbrs = [v for v in nbrs[np.argsort(deg[nbrs], kind="stable")]
                    if not visited[v]]
            for v in nbrs:
                visited[v] = True
            queue.extend(nbrs)
    if pos != n:
        raise RuntimeError(
            f"rcm: traversal covered {pos} of {n} vertices — adjacency "
            f"is inconsistent")
    return order[::-1].copy()


def bandwidth(rows, cols) -> int:
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size == 0:
        return 0
    return int(np.abs(rows - cols).max())


def greedy_coloring(rows, cols, n: int) -> np.ndarray:
    """Greedy distance-1 row coloring (ColPack's role for GS/Kaczmarz)."""
    indptr, adj = _adjacency(np.asarray(rows, np.int64),
                             np.asarray(cols, np.int64), n)
    color = np.full(n, -1, np.int64)
    for u in range(n):
        used = set(color[adj[indptr[u]:indptr[u + 1]]].tolist())
        c = 0
        while c in used:
            c += 1
        color[u] = c
    return color
