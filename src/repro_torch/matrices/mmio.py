"""Matrix Market exchange format IO (paper section 3.1: GHOST reads MM).

A numpy-only copy of ``repro.matrices.mmio`` for the port; files written
by either package read back identically in the other.

Supports coordinate real/integer/complex/pattern, general/symmetric/
skew-symmetric/hermitian. Host-side numpy; no scipy dependency.

Fidelity notes: ``integer`` fields are parsed with ``int`` (no float
round-trip, so 64-bit values survive exactly) and written back with an
``integer`` header, so a write->read roundtrip preserves dtype; blank
lines anywhere after the header are tolerated, as the format spec asks.
"""
from __future__ import annotations

import gzip
from typing import Optional, Tuple

import numpy as np

__all__ = ["read_matrix_market", "write_matrix_market"]

_FIELDS = ("real", "integer", "complex", "pattern")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


def _open(path, mode="rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _next_data_line(f, what: str):
    """Next non-blank line (data section tolerates blanks and comments)."""
    while True:
        line = f.readline()
        if not line:
            raise ValueError(f"unexpected end of file while reading {what}")
        if line.strip() and not line.startswith("%"):
            return line.split()


def read_matrix_market(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Returns (rows, cols, vals, (nrows, ncols)) with symmetry expanded.

    ``vals`` dtype follows the field: real -> float64, integer -> int64
    (parsed exactly, no float truncation), complex -> complex128,
    pattern -> float64 ones.
    """
    with _open(path) as f:
        header = f.readline().strip().split()
        if len(header) < 5 or header[0] != "%%MatrixMarket":
            raise ValueError(f"not a MatrixMarket file: {header}")
        _, obj, fmt, field, sym = [h.lower() for h in header[:5]]
        if obj != "matrix" or fmt != "coordinate":
            raise ValueError(f"only coordinate matrices supported, got {obj}/{fmt}")
        if field not in _FIELDS:
            raise ValueError(f"unknown field {field!r} (expected one of {_FIELDS})")
        if sym not in _SYMMETRIES:
            raise ValueError(f"unknown symmetry {sym!r} (expected one of {_SYMMETRIES})")
        nr, nc, nnz = map(int, _next_data_line(f, "size line"))
        rows = np.empty(nnz, np.int64)
        cols = np.empty(nnz, np.int64)
        if field == "complex":
            vals = np.empty(nnz, np.complex128)
        elif field == "integer":
            vals = np.empty(nnz, np.int64)
        elif field == "pattern":
            vals = np.ones(nnz, np.float64)
        else:
            vals = np.empty(nnz, np.float64)
        for k in range(nnz):
            parts = _next_data_line(f, f"entry {k + 1}/{nnz}")
            rows[k] = int(parts[0]) - 1
            cols[k] = int(parts[1]) - 1
            if field == "complex":
                vals[k] = float(parts[2]) + 1j * float(parts[3])
            elif field == "integer":
                vals[k] = int(parts[2])       # exact: no float truncation
            elif field == "pattern":
                pass
            else:
                vals[k] = float(parts[2])

    if sym in ("symmetric", "hermitian", "skew-symmetric"):
        off = rows != cols
        r2, c2 = cols[off], rows[off]
        if sym == "hermitian":
            v2 = np.conj(vals[off])
        elif sym == "skew-symmetric":
            v2 = -vals[off]
        else:
            v2 = vals[off]
        rows = np.concatenate([rows, r2])
        cols = np.concatenate([cols, c2])
        vals = np.concatenate([vals, v2])
    return rows, cols, vals, (nr, nc)


def write_matrix_market(path, rows, cols, vals, shape, *,
                        field: Optional[str] = None,
                        symmetry: str = "general") -> None:
    """Write COO triplets as a coordinate MatrixMarket file.

    ``field=None`` derives the header from the values' dtype (complex /
    integer / real), so integer matrices round-trip as ``integer`` rather
    than silently becoming ``real``.  Pass ``field="pattern"`` to write
    structure only.  ``symmetry`` is written to the header verbatim; for
    anything but ``general`` the caller must pass only the stored (lower)
    triangle, exactly as :func:`read_matrix_market` would re-expand it.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if field is None:
        if np.iscomplexobj(vals):
            field = "complex"
        elif np.issubdtype(vals.dtype, np.integer):
            field = "integer"
        else:
            field = "real"
    if field not in _FIELDS:
        raise ValueError(f"unknown field {field!r} (expected one of {_FIELDS})")
    if symmetry not in _SYMMETRIES:
        raise ValueError(
            f"unknown symmetry {symmetry!r} (expected one of {_SYMMETRIES})")
    with _open(path, "wt") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write(f"{shape[0]} {shape[1]} {len(vals)}\n")
        for r, c, v in zip(rows, cols, vals):
            if field == "pattern":
                f.write(f"{r + 1} {c + 1}\n")
            elif field == "complex":
                f.write(f"{r + 1} {c + 1} {v.real:.17g} {v.imag:.17g}\n")
            elif field == "integer":
                f.write(f"{r + 1} {c + 1} {int(v)}\n")
            else:
                f.write(f"{r + 1} {c + 1} {v:.17g}\n")
