"""SELL-C-sigma sparse matrix storage (paper C1), in PyTorch.

The port of ``repro.core.sellcs``.  A sparse matrix is cut into chunks of
``C`` rows; within a *sorting window* of ``sigma`` rows, rows are sorted
by descending nonzero count before chunk assembly, which keeps the
zero-padding small.  Chunk entries are stored column-major within the
chunk, so the ``C`` rows of one chunk column sit next to each other in
memory: on the GPU the ``C`` threads that own a chunk's rows read them in
one coalesced load.

**Storage vs compute dtype.**  ``store_dtype=`` keeps ``vals`` in
``bfloat16``/``float16``/``float32`` while ``compute_dtype`` (the
``dtype=`` argument) is what every product accumulates in.  Narrow
storage rounds from the compute dtype exactly as the JAX package does, so
both packages hold bit-identical arrays.

Vectors live in *permuted* space (like GHOST): use :meth:`SellCS.permute`
and :meth:`SellCS.unpermute` at the boundaries.  For square matrices the
column indices are remapped through the inverse permutation at
construction time so that SpMV never gathers through the permutation.

Construction is host-side numpy, as in the JAX package; the finished
arrays then move to ``device``, which is the card unless the caller names
another (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.execution import resolve_device

__all__ = [
    "SellCS",
    "from_coo",
    "from_csr",
    "from_dense",
    "from_callback",
    "to_dense",
]

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True, eq=False)
class SellCS:
    """SELL-C-sigma matrix: eight tensors on one device plus static sizes."""

    vals: torch.Tensor        # (cap,) chunk-column-major nonzero values (padded)
    cols: torch.Tensor        # (cap,) int32 column indices (permuted space)
    chunk_off: torch.Tensor   # (nchunks,) int32, chunk c spans vals[off*C:(off+len)*C]
    chunk_len: torch.Tensor   # (nchunks,) int32 padded width of chunk c
    rowids: torch.Tensor      # (cap,) int32 row id (permuted space) per slot
    row_len: torch.Tensor     # (nrows_pad,) int32 stored entries per permuted row
    perm: torch.Tensor        # (nrows_pad,) int32 sorted-pos -> original row
    iperm: torch.Tensor       # (nrows_pad,) int32 original row -> sorted-pos

    C: int
    sigma: int
    nrows: int
    ncols: int
    nnz: int
    w_align: int
    permuted_cols: bool
    # compute (accumulation) dtype name when ``vals`` is stored narrower;
    # None = vals *are* the compute dtype
    compute_dtype: Optional[str] = None

    @property
    def nchunks(self) -> int:
        return self.nrows_pad // self.C

    @property
    def nrows_pad(self) -> int:
        return _ceil_to(self.nrows, self.C)

    @property
    def cap(self) -> int:
        return int(self.vals.shape[0])

    @property
    def beta(self) -> float:
        """Storage efficiency: nnz / padded slots (paper's beta)."""
        return self.nnz / max(1, self.cap)

    @property
    def dtype(self) -> torch.dtype:
        """The *compute* dtype: what products accumulate in and what every
        solver vector uses."""
        if self.compute_dtype is not None:
            return getattr(torch, self.compute_dtype)
        return self.vals.dtype

    @property
    def store_dtype(self) -> torch.dtype:
        """The *storage* dtype of ``vals`` (the memory-traffic dtype)."""
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    def permute(self, v) -> torch.Tensor:
        """Original-space vector -> permuted (sorted) space, padded to nrows_pad."""
        v = torch.as_tensor(v, device=self.device)
        pad = self.nrows_pad - self.nrows
        if pad:
            v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
        return v[self.perm.long()]

    def unpermute(self, v: torch.Tensor) -> torch.Tensor:
        """Permuted-space (padded) vector -> original space (trimmed)."""
        return v[self.iperm.long()][: self.nrows]

    def nnz_per_row(self) -> np.ndarray:
        """Stored entries per permuted-space row, from the construction-
        recorded lengths (explicitly stored zeros count)."""
        return self.row_len.cpu().numpy().astype(np.int64)

    def valid_slots(self) -> np.ndarray:
        """Boolean (cap,) mask of slots holding a stored entry (host-side):
        slot ``(chunk_off[c] + k) * C + lane`` is valid iff
        ``k < row_len[c*C + lane]``."""
        co = self.chunk_off.cpu().numpy().astype(np.int64)
        rid = self.rowids.cpu().numpy().astype(np.int64)
        slot = np.arange(self.cap, dtype=np.int64)
        k = slot // self.C - co[rid // self.C]
        return k < self.row_len.cpu().numpy().astype(np.int64)[rid]


def _ceil_to(x, m: int):
    return ((x + m - 1) // m) * m


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    found = getattr(torch, name, None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return found


def _narrow(vals: np.ndarray, sd: torch.dtype) -> torch.Tensor:
    """Round compute-dtype values to the storage dtype as the JAX package
    does: float16 in one correctly rounded step (numpy), bfloat16 through
    float32 (torch, as XLA converts)."""
    if sd == torch.bfloat16:
        return torch.from_numpy(vals).to(sd)
    return torch.from_numpy(vals.astype(_np_dtype(sd)))


def from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    *,
    C: int = 32,
    sigma: int = 1,
    w_align: int = 1,
    dtype=None,
    store_dtype=None,
    row_perm: Optional[np.ndarray] = None,
    permute_columns: Optional[bool] = None,
    device: Device = None,
) -> SellCS:
    """Build a SELL-C-sigma matrix from COO triplets (host-side numpy).

    ``sigma`` must be a multiple of ``C`` (or 1).  ``w_align`` pads every
    chunk width to a multiple (kept for layout parity with the JAX
    package; the CUDA kernel takes any width).  ``dtype`` is the compute
    dtype; ``store_dtype`` optionally stores ``vals`` narrower.
    ``row_perm`` imposes an external row permutation (sorted-pos ->
    original row, length nrows_pad); ``permute_columns`` overrides the
    default column remapping (remap iff square and no external perm).
    ``device=None`` means the card and raises when there is none.
    """
    dev = resolve_device(device)
    nrows, ncols = map(int, shape)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if dtype is not None:
        vals = vals.astype(_np_dtype(dtype))
    if sigma != 1 and sigma % C != 0:
        raise ValueError(f"sigma ({sigma}) must be 1 or a multiple of C ({C})")
    if rows.size:
        if rows.min() < 0 or rows.max() >= nrows:
            raise ValueError("row index out of range")
        if cols.min() < 0 or cols.max() >= ncols:
            raise ValueError("col index out of range")

    # CSR-ify (sorted, duplicates summed); the stable sort of the one key
    # row * ncols + col is lexsort((cols, rows)), in half the time
    order = np.argsort(rows * ncols + cols, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        dup = np.zeros(rows.size, bool)
        dup[1:] = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if dup.any():
            keep = ~dup
            grp = np.cumsum(keep) - 1
            nv = np.zeros(keep.sum(), vals.dtype)
            np.add.at(nv, grp, vals)
            rows, cols, vals = rows[keep], cols[keep], nv
    nnz = int(rows.size)

    nrows_pad = _ceil_to(nrows, C)
    rowlen = np.bincount(rows, minlength=nrows_pad).astype(np.int64)

    # sigma sorting: stable descending rowlen within each window
    if row_perm is not None:
        perm = np.asarray(row_perm, np.int64)
        if perm.shape != (nrows_pad,):
            raise ValueError(f"row_perm must have shape ({nrows_pad},)")
    elif sigma > 1:
        window = np.arange(nrows_pad, dtype=np.int64) // sigma
        perm = np.lexsort((-rowlen, window)).astype(np.int64)
    else:
        perm = np.arange(nrows_pad, dtype=np.int64)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(nrows_pad)

    sorted_rowlen = rowlen[perm]

    nchunks = nrows_pad // C
    width = sorted_rowlen.reshape(nchunks, C).max(axis=1, initial=0)
    chunk_len = _ceil_to(np.maximum(width, 1), w_align).astype(np.int64)
    chunk_off = np.zeros(nchunks, np.int64)
    chunk_off[1:] = np.cumsum(chunk_len)[:-1]
    cap = int(chunk_len.sum()) * C

    # scatter CSR rows into chunk-column-major slots: element k of sorted
    # row s in chunk c goes to slot (chunk_off[c] + k) * C + (s - c*C)
    # an empty matrix keeps the requested dtype (the JAX package falls
    # back to float32 whenever there are no values)
    out_vals = np.zeros(
        cap, vals.dtype if vals.size or dtype is not None else np.float32)
    out_cols = np.zeros(cap, np.int64)
    if nnz:
        sorted_pos = iperm[rows]
        chunk_of = sorted_pos // C
        lane = sorted_pos % C
        starts = np.concatenate([[0], np.cumsum(rowlen[:nrows])[:-1]])
        k = np.arange(nnz, dtype=np.int64) - starts[rows]
        slot = (chunk_off[chunk_of] + k) * C + lane
        out_vals[slot] = vals
        out_cols[slot] = cols
    # rowids for every slot (padding slots get their row too, with val 0)
    # (chunk c spans chunk_len[c] * C slots from chunk_off[c] * C, a
    # multiple of C, so a slot's lane is slot % C)
    chunk_of_slot = np.repeat(np.arange(nchunks, dtype=np.int64),
                              chunk_len * C)
    out_rowid = chunk_of_slot * C + np.arange(cap, dtype=np.int64) % C

    # permuted column space for square matrices: col j -> iperm[j], for
    # every occupied slot (explicitly stored zeros included)
    if permute_columns is None:
        permuted_cols = (nrows == ncols) and row_perm is None
    else:
        permuted_cols = bool(permute_columns)
    if permuted_cols and nnz:
        out_cols[slot] = iperm[out_cols[slot]]

    tvals = torch.from_numpy(out_vals)
    compute_dtype = None
    if store_dtype is not None:
        sd = _torch_dtype(store_dtype)
        cd = tvals.dtype
        if not sd.is_floating_point:
            raise ValueError(
                f"store_dtype must be a real floating dtype, got {sd}")
        if cd.is_complex:
            raise ValueError(
                f"store_dtype is not supported for complex values "
                f"(compute dtype {cd})")
        if not cd.is_floating_point:
            raise ValueError(
                f"store_dtype requires a floating compute dtype, got {cd}; "
                f"pass dtype= (float values would stream from storage into "
                f"integer solver states otherwise)")
        if torch.finfo(sd).bits > torch.finfo(cd).bits:
            raise ValueError(
                f"store_dtype {sd} is wider than the compute dtype {cd}; "
                f"storage may only narrow the value stream")
        compute_dtype = out_vals.dtype.name
        tvals = _narrow(out_vals, sd)

    def int32(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    return SellCS(
        vals=tvals.to(dev),
        cols=int32(out_cols),
        chunk_off=int32(chunk_off),
        chunk_len=int32(chunk_len),
        rowids=int32(out_rowid),
        row_len=int32(sorted_rowlen),
        perm=int32(perm),
        iperm=int32(iperm),
        C=int(C),
        sigma=int(sigma),
        nrows=nrows,
        ncols=ncols,
        nnz=nnz,
        w_align=int(w_align),
        permuted_cols=bool(permuted_cols),
        compute_dtype=compute_dtype,
    )


def from_csr(indptr, indices, data, shape, **kw) -> SellCS:
    """Paper section 5.1: construct SELL-C-sigma from raw CRS arrays."""
    indptr = np.asarray(indptr, np.int64)
    rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    return from_coo(rows, np.asarray(indices), np.asarray(data), shape, **kw)


def from_dense(a: np.ndarray, **kw) -> SellCS:
    a = np.asarray(a)
    r, c = np.nonzero(a)
    return from_coo(r, c, a[r, c], a.shape, **kw)


def from_callback(
    rowfunc: Callable[[int], Tuple[np.ndarray, np.ndarray]],
    nrows: int,
    ncols: Optional[int] = None,
    *,
    maxnz_per_row: int = 64,
    **kw,
) -> SellCS:
    """GHOST's preferred construction path: a per-row callback
    ``rowfunc(i) -> (cols, vals)``, like the paper's C ``mat`` callback."""
    ncols = nrows if ncols is None else ncols
    rr, cc, vv = [], [], []
    for i in range(nrows):
        c, v = rowfunc(i)
        c = np.asarray(c, np.int64).ravel()
        v = np.asarray(v).ravel()
        if c.size > maxnz_per_row:
            raise ValueError(f"row {i}: {c.size} > maxnz_per_row={maxnz_per_row}")
        rr.append(np.full(c.size, i, np.int64))
        cc.append(c)
        vv.append(v)
    rows = np.concatenate(rr) if rr else np.zeros(0, np.int64)
    cols = np.concatenate(cc) if cc else np.zeros(0, np.int64)
    vals = np.concatenate(vv) if vv else np.zeros(0)
    return from_coo(rows, cols, vals, (nrows, ncols), **kw)


def to_dense(m: SellCS) -> np.ndarray:
    """Densify (original index space, compute dtype) — small matrices only.
    Slot validity comes from :meth:`SellCS.valid_slots`, so explicitly
    stored zeros keep their position."""
    vals = m.vals.to(m.dtype).cpu().numpy()
    cols = m.cols.cpu().numpy()
    rowid = m.rowids.cpu().numpy()
    perm = m.perm.cpu().numpy()
    out = np.zeros((m.nrows_pad, m.ncols), vals.dtype)
    mask = m.valid_slots()
    r_orig = perm[rowid[mask]]
    c = cols[mask]
    if m.permuted_cols:
        c = perm[c]
    np.add.at(out, (r_orig, c), vals[mask])
    return out[: m.nrows]
