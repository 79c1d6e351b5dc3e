"""Progressive-edge-growth code construction (host-side, native kernel).

The pipeline equivalent of the reference's peg.sh: degree sequence (from an
ensemble's node-perspective VN distribution) -> PEG Tanner graph -> alist.
The graph construction runs in csrc/peg.cpp (built into the port's own
library by _native.py); a pure-Python BFS fallback covers compiler-less
environments.  A copy of lut_ldpc_tpu/core/peg.py.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["peg_construct", "degree_sequence_from_ensemble", "peg_code_from_ensemble"]


def degree_sequence_from_ensemble(ens, N: int) -> np.ndarray:
    """Per-symbol degree sequence (ascending) realizing the ensemble's
    node-perspective VN distribution over N symbols (MainPEG.C:141-168
    assignment semantics: cumulative rounding, ascending degrees)."""
    Lam = ens.Lam_node()
    counts = np.floor(np.cumsum(Lam) * N + 0.5).astype(np.int64)
    counts = np.diff(np.concatenate([[0], counts]))
    counts[-1] = N - counts[:-1].sum()
    seq = np.repeat(ens.degree_lam, counts)
    return np.sort(seq).astype(np.int32)


def peg_construct(
    M: int, N: int, sym_deg: np.ndarray, sgl_concent: int = 1,
    tgt_girth: int = 100000, seed: int = 1234,
):
    """Build a Tanner graph; returns (cols, local_girth) with cols a list of
    per-variable check-index arrays (ascending)."""
    sym_deg = np.ascontiguousarray(sym_deg, dtype=np.int32)
    from .._native import get_lib

    lib = get_lib()
    E = int(sym_deg.sum())
    out = np.empty(E, dtype=np.int32)
    lg = np.empty(N, dtype=np.int32)
    if lib is not None:
        i32p = ctypes.POINTER(ctypes.c_int32)
        rc = lib.peg_construct(
            M, N, sym_deg.ctypes.data_as(i32p), sgl_concent, tgt_girth,
            ctypes.c_uint64(seed),
            out.ctypes.data_as(i32p), lg.ctypes.data_as(i32p),
        )
        if rc != 0:
            raise RuntimeError(f"peg_construct failed with code {rc}")
    else:
        out, lg = _peg_python(M, N, sym_deg, sgl_concent, tgt_girth, seed)
    starts = np.concatenate([[0], np.cumsum(sym_deg)])
    cols = [np.sort(out[starts[v] : starts[v + 1]]) for v in range(N)]
    return cols, lg


def _peg_python(M, N, sym_deg, sgl_concent, tgt_girth, seed):
    """Reference-free Python fallback (slow; small codes only)."""
    rng = np.random.default_rng(seed)
    E = int(sym_deg.sum())
    max_deg = np.full(M, np.iinfo(np.int32).max, dtype=np.int64)
    if sgl_concent == 0:
        base, extra = divmod(E, M)
        max_deg[:] = base
        max_deg[:extra] += 1
    expand_cap = max((tgt_girth - 4) // 2, 1) if tgt_girth < 100000 else 10**6
    chk_adj = [[] for _ in range(M)]
    chk_deg = np.zeros(M, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(sym_deg)])
    out = np.empty(E, dtype=np.int32)
    lg_out = np.empty(N, dtype=np.int32)
    for k in range(N):
        free = np.nonzero(chk_deg < max_deg)[0]
        first = free[np.argmin(chk_deg[free])]
        out[starts[k]] = first
        chk_adj[first].append(k)
        chk_deg[first] += 1
        lg = 10**6
        for m in range(1, sym_deg[k]):
            reached = np.zeros(M, dtype=bool)
            seen_sym = np.zeros(N, dtype=bool)
            seen_sym[k] = True
            frontier = list(set(out[starts[k] : starts[k] + m]))
            reached[frontier] = True
            depth = 0
            last_layer = []
            while depth < expand_cap:
                nxt = []
                for c in frontier:
                    for s in chk_adj[c]:
                        if seen_sym[s]:
                            continue
                        seen_sym[s] = True
                        lim = sym_deg[s] if s < k else m
                        for e in range(lim):
                            c2 = out[starts[s] + e]
                            if not reached[c2]:
                                reached[c2] = True
                                nxt.append(c2)
                if not nxt:
                    break
                depth += 1
                last_layer = nxt
                if reached.all():
                    break
                frontier = nxt
            if reached.all() and last_layer:
                cands = [c for c in last_layer if chk_deg[c] < max_deg[c]]
                lg = min(lg, depth)
            else:
                cands = np.nonzero(~reached & (chk_deg < max_deg))[0].tolist()
            if not cands:
                used = set(out[starts[k] : starts[k] + m])
                cands = [c for c in range(M) if chk_deg[c] < max_deg[c] and c not in used]
                lg = 0
            dmin = min(chk_deg[c] for c in cands)
            cands = [c for c in cands if chk_deg[c] == dmin]
            chosen = int(rng.choice(cands))
            out[starts[k] + m] = chosen
            chk_adj[chosen].append(k)
            chk_deg[chosen] += 1
        lg_out[k] = -1 if lg >= 10**6 else 2 * lg + 4
    return out, lg_out


def peg_code_from_ensemble(
    ens, M: int, N: int, sgl_concent: int = 1, tgt_girth: int = 100000,
    seed: int = 1234,
):
    """ens -> TannerGraph via PEG (the peg.sh pipeline in one call)."""
    from .tanner import TannerGraph

    seq = degree_sequence_from_ensemble(ens, N)
    cols, lg = peg_construct(M, N, seq, sgl_concent, tgt_girth, seed)
    return TannerGraph.from_cols([c.astype(np.int64) for c in cols], N, M), lg
