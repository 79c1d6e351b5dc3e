"""Mutual-information-optimal symmetric quantizer design.

`quant_mi_sym` is the engine that designs every LUT in the framework: given a
symmetric input pmf over M labels it finds the K-level quantizer maximizing
the mutual information between the (binary, symmetric) channel input and the
quantizer output, via a dynamic program over contiguous interval boundaries
in LLR-sorted order (an instance of the information-bottleneck problem with
the optimal-quantizer contiguity property).

Semantics mirror reference src/common.cpp:230-369 exactly, including
argmax tie-breaking (first/lowest boundary wins) and the symmetric treatment
of zero-LLR labels, so designed LUTs are bit-identical to the reference's.
The DP inner maximization is vectorized over numpy instead of looping.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["quant_mi_sym", "sym_llr_sort_unique", "quant_lin", "quant_nonlin"]


def sym_llr_sort_unique(p_in: np.ndarray, llr_delta: float = 0.0):
    """Sort a symmetric pmf by LLR and merge duplicate-LLR labels.

    Returns (p_sorted, idx_in, idx_sorted) where idx_in is the stable argsort
    of llr(m) = log p[m] - log p[M-1-m] (ties broken by original index) and
    idx_sorted maps each sorted position to its merged output label, built
    symmetrically so zero-LLR mass splits evenly across both halves.
    Matches common.cpp:333-369.
    """
    p_in = np.asarray(p_in, dtype=np.float64)
    M_in = len(p_in)
    with np.errstate(divide="ignore"):
        logp = np.log(p_in)
    llr = logp - logp[::-1]
    idx_in = np.argsort(llr, kind="stable")
    if not np.all(idx_in + idx_in[::-1] == M_in - 1):
        raise ValueError("sym_llr_sort_unique: couldn't find symmetric permutation")

    # group consecutive (chained) near-equal LLRs in the lower half
    idx_sorted_half = np.zeros(M_in // 2, dtype=np.int64)
    dupl = llr[idx_in[0]]
    dupl_idx = 0
    num_dupl = 0
    for mm in range(1, M_in // 2):
        if abs(llr[idx_in[mm]] - dupl) <= llr_delta:
            num_dupl += 1
        else:
            dupl_idx += 1
        idx_sorted_half[mm] = dupl_idx
        dupl = llr[idx_in[mm]]

    top = 2 * idx_sorted_half.max() + 1
    idx_sorted = np.concatenate([idx_sorted_half, top - idx_sorted_half[::-1]])
    M = M_in - 2 * num_dupl
    p_sorted = np.zeros(M, dtype=np.float64)
    np.add.at(p_sorted, idx_sorted, p_in[idx_in])
    return p_sorted, idx_in, idx_sorted


def _xlog2y(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    m = x > 0
    out[m] = x[m] * np.log2(y[m])
    return out


def quant_mi_sym(p_in: np.ndarray, Nq: int, is_sorted: bool = False):
    """Design the MI-optimal K=Nq level symmetric quantizer for pmf p_in.

    Returns (mi, p_out, Q_out): achieved mutual information, quantized output
    pmf (length Nq) and the full label map Q_out (length len(p_in), values in
    0..Nq-1, symmetric: Q[m] = Nq-1-Q[M-1-m]).  Matches common.cpp:230-331.
    """
    p_in = np.asarray(p_in, dtype=np.float64)
    K = int(Nq)
    M_in = len(p_in)
    if M_in % 2 != 0:
        raise ValueError("quant_mi_sym: input pmf length must be even")
    if K < 2 or K % 2 != 0:
        raise ValueError("quant_mi_sym: number of output labels must be even and >= 2")
    # the DP's partial-MI table is (M/2)^2 doubles (common.cpp:276-284 has
    # the same footprint); refuse infeasible joint alphabets with a clear
    # error instead of a native bad_alloc (e.g. a flat 6-input root LUT at
    # q3/q4 -> M ~ 5e5, table ~ 550 GB; the reference aborts there too)
    if K < M_in and (M_in // 2) ** 2 * 8 > int(
        os.environ.get("LUT_LDPC_QUANT_MEM", 4 << 30)
    ):
        raise ValueError(
            f"quant_mi_sym: joint alphabet of {M_in} entries needs "
            f"{(M_in // 2) ** 2 * 8 / 2**30:.1f} GiB for the DP table; "
            "use a deeper tree decomposition (2-input stages) or lower "
            "resolutions (LUT_LDPC_QUANT_MEM overrides the cap)"
        )

    from .._native import quant_mi_sym_native

    native = quant_mi_sym_native(p_in, K, is_sorted)
    if native is not None:
        return native

    if not is_sorted:
        p_sorted, idx_in, idx_sorted = sym_llr_sort_unique(p_in)
        M = len(p_sorted)
    else:
        idx_in = np.arange(M_in, dtype=np.int64)
        idx_sorted = np.arange(M_in, dtype=np.int64)
        p_sorted = p_in
        M = M_in

    Q_out = np.zeros(M_in, dtype=np.int64)

    if K >= M:
        # trivial: each distinct label its own output level (common.cpp:257-272)
        outlabel = 0
        for mm in range(M_in // 2):
            if idx_sorted[mm] > outlabel:
                outlabel += 1
            Q_out[idx_in[M_in - 1 - mm]] = K - 1 - outlabel
            Q_out[idx_in[mm]] = outlabel
        p_out = np.zeros(K, dtype=np.float64)
        np.add.at(p_out, Q_out, p_in)
        from .pmf import get_mi_bcpmf_sym

        return get_mi_bcpmf_sym(p_in), p_out, Q_out

    H = M // 2
    Kh = K // 2
    # partial mutual information g[ap, a] of interval [ap, a] (upper triangle):
    # p_plus = mass of upper-half labels ap..a, p_minus = mirrored lower half.
    # Accumulate with a masked row-wise cumsum so the fp summation order is
    # identical to the reference's sequential loop (bit-exact ties in the DP).
    ap_idx = np.arange(H)[:, None]
    a_idx = np.arange(H)[None, :]
    tri = (a_idx >= ap_idx).astype(np.float64)
    p_plus = np.cumsum(tri * p_sorted[H:][None, :], axis=1)
    p_minus = np.cumsum(tri * p_sorted[:H][::-1][None, :], axis=1)
    tot = p_plus + p_minus
    with np.errstate(divide="ignore", invalid="ignore"):
        g = _xlog2y(p_plus, np.where(tot > 0, 2 * p_plus / np.where(tot > 0, tot, 1.0), 1.0))
        g += _xlog2y(p_minus, np.where(tot > 0, 2 * p_minus / np.where(tot > 0, tot, 1.0), 1.0))
    g[a_idx < ap_idx] = 0.0

    # DP over number of used intervals (common.cpp:288-304); h = first argmax
    NEG = -np.finfo(np.float64).max
    S = np.zeros((H, Kh), dtype=np.float64)
    h = np.zeros((H, Kh), dtype=np.int64)
    span = (M - K) // 2
    S[: span + 1, 0] = g[0, : span + 1]
    col = np.arange(H)
    for zz in range(1, Kh):
        a_lo, a_hi = zz, zz + span  # inclusive
        # candidate[ap, a] = S[ap-1, zz-1] + g[ap, a] for ap in [zz, a]
        cand = S[:-1, zz - 1][:, None] + g[1:, :]  # rows index ap = 1..H-1
        ap_row = np.arange(1, H)[:, None]
        valid = (ap_row >= zz) & (ap_row <= col[None, :])
        cand = np.where(valid, cand, NEG)
        best_ap = np.argmax(cand, axis=0) + 1  # first (lowest) argmax
        best_val = cand[best_ap - 1, col]
        sel = slice(a_lo, a_hi + 1)
        S[sel, zz] = best_val[sel]
        h[sel, zz] = best_ap[sel]

    # backtrack optimal boundaries (common.cpp:307-311)
    astar = np.zeros(Kh + 1, dtype=np.int64)
    astar[Kh] = H
    for kk in range(Kh - 1, 0, -1):
        astar[kk] = h[astar[kk + 1] - 1, kk]

    # build the symmetric label map (common.cpp:314-320)
    outlabel = 0
    half = M_in // 2
    for mm in range(half):
        if idx_sorted[mm + half] - H >= astar[outlabel + 1]:
            outlabel += 1
        Q_out[idx_in[half + mm]] = Kh + outlabel
        Q_out[idx_in[half - 1 - mm]] = Kh - 1 - outlabel

    p_out = np.zeros(K, dtype=np.float64)
    np.add.at(p_out, Q_out, p_in)
    return float(S[H - 1, Kh - 1]), p_out, Q_out


def quant_lin(x: float, delta: float, N: int) -> int:
    """Uniform midrise quantizer index in 0..N-1 (common.cpp:112)."""
    y = int(np.ceil(x / delta)) + N // 2 - 1
    return min(max(y, 0), N - 1)


def quant_nonlin(x, boundaries) -> np.ndarray:
    """Index = number of leading boundaries strictly below x (common.cpp:120-138).

    boundaries must be sorted ascending; output in 0..len(boundaries).
    """
    boundaries = np.asarray(boundaries, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    return np.searchsorted(boundaries, x, side="left").astype(np.int64)
