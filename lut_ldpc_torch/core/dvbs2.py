"""DVB-S2-family quasi-cyclic structure detection.

The ETSI DVB-S2 standard LDPC matrices (the reference toolkit's flagship
input, codes/rate0.50_irreg_dvbs2_N64800.alist) are built from 360-column groups whose check
connections shift by q = M/360 per column, plus a dual-diagonal
accumulator for the parity bits.  Under the classic row/column
permutation

    row  m = t*q + i      ->  check  (block i,      z = t)
    col  c = g*360 + t    ->  var    (block g,      z = t)   (info)
    col  K + t*q + i      ->  var    (block K/360+i, z = t)  (parity)

the matrix becomes an (q x (K/360 + q)) grid of 360 x 360 circulants:
weight-1 except a handful of weight-2 cells (two base shifts landing in
the same block row), and ONE incomplete circulant — the accumulator
wrap misses a single entry (the last parity column has degree 1).  The
missing entries are returned as PHANTOM completions: the expanded graph
carries them as pinned edges so decoding is exact for the TRUE matrix
(decoder semantics in decoder/codec.py decode_ref), while the message
permutations decompose into per-circulant rolls that the QC kernels
consume (decoder/qc_kernels.py).

Nothing here is DVB-S2-specific beyond the permutation template: any
matrix that is circulant under the (t*q + i) row indexing is accepted.
"""

from __future__ import annotations

import numpy as np

from .alist import read_alist_cols
from .qc import QCStructure, qc_expand

__all__ = ["periodic_qc_structure", "load_periodic_alist"]

_MAX_PHANTOMS = 4  # sanity bound; DVB-S2 has exactly 1


def periodic_qc_structure(cols, nvar: int, nchk: int, Z: int = 360):
    """Detect the DVB-S2-family QC structure of a parity matrix.

    cols: per-variable arrays of check indices (any order).  Returns
    (QCStructure, col_perm, row_perm) with col_perm[orig] = permuted
    variable index and row_perm[orig] = permuted check index, or None
    when the matrix is not circulant under this permutation template
    (weight > 2 cells, or more than a few missing circulant entries).
    """
    N, M = nvar, nchk
    if M % Z or N % Z:
        return None
    q = M // Z
    K = N - M
    if K % Z or K < 0:
        return None
    kb = K // Z  # info blocks
    nb = kb + q
    # permutations
    col_perm = np.empty(N, dtype=np.int64)
    c = np.arange(K)
    g, t = c // Z, c % Z
    col_perm[:K] = g * Z + t
    j = np.arange(M)
    t, i = j // q, j % q
    col_perm[K:] = (kb + i) * Z + t
    m = np.arange(M)
    t, i = m // q, m % q
    row_perm = i * Z + t

    # per-cell shift multisets
    counts: dict = {}
    for c in range(N):
        pc = col_perm[c]
        bc, zc = pc // Z, pc % Z
        for mm in cols[c]:
            pm = row_perm[mm]
            br, zr = pm // Z, pm % Z
            key = (int(br), int(bc), int((zr - zc) % Z))
            e = counts.setdefault(key, [])
            e.append(int(zc))
    base = np.full((q, nb), -1, dtype=np.int64)
    base2 = np.full((q, nb), -1, dtype=np.int64)
    phantoms = []
    for (br, bc, s), zs in sorted(counts.items()):
        if len(zs) < Z - _MAX_PHANTOMS or len(set(zs)) != len(zs):
            return None
        if len(zs) < Z:
            for z_v in sorted(set(range(Z)) - set(zs)):
                phantoms.append((bc, z_v, br, (z_v + s) % Z))
        if base[br, bc] < 0:
            base[br, bc] = s
        elif base2[br, bc] < 0:
            base2[br, bc] = s
        else:
            return None  # weight > 2 cell
    if len(phantoms) > _MAX_PHANTOMS:
        return None
    # canonical order: base carries the smaller shift
    swap = (base2 >= 0) & (base2 < base)
    if swap.any():
        b = base[swap]
        base[swap] = base2[swap]
        base2[swap] = b
    qc = QCStructure(Z=Z, mb=q, nb=nb, base=base,
                     base2=base2 if (base2 >= 0).any() else None,
                     phantoms=tuple(phantoms))
    return qc, col_perm, row_perm


def load_periodic_alist(path: str, Z: int = 360):
    """alist -> (expanded QC TannerGraph, col_perm, row_perm).

    The graph is the PERMUTED matrix (plus phantom completions); permute
    channel LLRs with col_perm on the way in (llr_perm[:, col_perm[c]] =
    llr[:, c]) and invert on the way out.  For zero-codeword / symmetric-
    channel Monte-Carlo the permutation is statistically irrelevant.
    Raises ValueError when the structure is absent."""
    cols, nvar, nchk = read_alist_cols(path)
    out = periodic_qc_structure(cols, nvar, nchk, Z)
    if out is None:
        raise ValueError(f"{path}: no {Z}-periodic QC structure")
    qc, col_perm, row_perm = out
    g = qc_expand(qc)
    g.qc_col_perm = col_perm
    g.qc_row_perm = row_perm
    return g, col_perm, row_perm
