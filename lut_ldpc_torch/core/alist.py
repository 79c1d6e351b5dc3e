"""alist sparse parity-check matrix I/O (MacKay format).

Format (as produced/consumed by IT++ GF2mat_sparse_alist and the reference's
`codes/*.alist` assets):

    nvar nchk
    max_col_deg max_row_deg
    col degrees (nvar ints)
    row degrees (nchk ints)
    per column: row indices, 1-based (zero-padded to max_col_deg or unpadded)
    per row: column indices, 1-based (zero-padded to max_row_deg or unpadded)

H is (nchk, nvar); columns are variable nodes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_alist", "read_alist_cols", "write_alist"]


def read_alist_cols(path: str):
    """Read an alist file into (col_lists, nvar, nchk).

    col_lists[v] is the sorted array of check-row indices (0-based) of
    variable node v.  Handles both the zero-padded and unpadded variants.
    """
    with open(path) as f:
        tokens = [int(t) for t in f.read().split()]
    pos = 0

    def take(k):
        nonlocal pos
        out = tokens[pos : pos + k]
        pos += k
        return out

    n, m = take(2)
    max_cd, max_rd = take(2)
    col_deg = np.array(take(n), dtype=np.int64)
    row_deg = np.array(take(m), dtype=np.int64)
    if col_deg.max() > max_cd or row_deg.max() > max_rd:
        raise ValueError("alist: inconsistent max degrees")

    padded_total = pos + n * max_cd + m * max_rd
    unpadded_total = pos + int(col_deg.sum()) + int(row_deg.sum())
    if len(tokens) >= padded_total:
        padded = True
    elif len(tokens) >= unpadded_total:
        padded = False
    else:
        raise ValueError("alist: file truncated")

    cols = []
    for v in range(n):
        raw = take(max_cd if padded else int(col_deg[v]))
        idx = np.array([x - 1 for x in raw if x > 0], dtype=np.int64)
        if len(idx) != col_deg[v]:
            raise ValueError(f"alist: column {v} degree mismatch")
        cols.append(np.sort(idx))
    return cols, n, m


def read_alist(path: str) -> np.ndarray:
    """Read an alist file into a dense uint8 parity matrix H (nchk, nvar)."""
    cols, n, m = read_alist_cols(path)
    if n * m > 3e9:
        raise MemoryError("read_alist: code too large for dense H; use read_alist_cols")
    H = np.zeros((m, n), dtype=np.uint8)
    for v in range(n):
        H[cols[v], v] = 1
    return H


def write_alist(path: str, H: np.ndarray) -> None:
    """Write a dense (nchk, nvar) 0/1 matrix in zero-padded alist format."""
    H = np.asarray(H)
    m, n = H.shape
    col_idx = [np.nonzero(H[:, v])[0] for v in range(n)]
    row_idx = [np.nonzero(H[c, :])[0] for c in range(m)]
    max_cd = max(len(c) for c in col_idx)
    max_rd = max(len(r) for r in row_idx)
    with open(path, "w") as f:
        f.write(f"{n} {m}\n{max_cd} {max_rd}\n")
        f.write(" ".join(str(len(c)) for c in col_idx) + "\n")
        f.write(" ".join(str(len(r)) for r in row_idx) + "\n")
        for c in col_idx:
            entries = [str(x + 1) for x in c] + ["0"] * (max_cd - len(c))
            f.write(" ".join(entries) + "\n")
        for r in row_idx:
            entries = [str(x + 1) for x in r] + ["0"] * (max_rd - len(r))
            f.write(" ".join(entries) + "\n")
