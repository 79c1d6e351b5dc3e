"""Quasi-cyclic LDPC construction: the TPU-native code family.

The reference constructs unstructured PEG codes (peg/BigGirth.C) whose
Tanner-graph message permutation is an arbitrary row gather — on TPU that
gather is DMA-issue-rate-bound (~100 ns/row), ~5x off HBM bandwidth, and
dominates decode time.  A quasi-cyclic code's permutation decomposes into
per-circulant cyclic shifts: contiguous `jnp.roll` copies that XLA fuses
into the adjacent compute passes at full memory bandwidth.  QC-LDPC is the
standard deployed construction (802.11n/802.16e/5G-NR all use it) and its
BER at matched degree distributions is on par with PEG; the LUT design
path is untouched (LUTs depend only on the ensemble and design sigma,
LDPC_Code_LUT.cpp:699-746).

H is an (mb x nb) grid of Z x Z blocks; entry s >= 0 denotes the circulant
C_s with C_s[z', z] = 1 iff z' == (z + s) mod Z, entry -1 a zero block.
Shift selection is greedy-random subject to the standard cycle conditions
(Fossorier 2004): a length-2k cycle through circulants (i_1,j_1), (i_2,
j_1), (i_2,j_2), ..., (i_1,j_k) exists iff the alternating shift sum is
divisible by Z; we forbid 4- and 6-cycles, giving girth >= 8.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from .tanner import TannerGraph

__all__ = ["QCStructure", "qc_expand", "qc_generate_regular",
           "qc_generate_irregular", "save_qc", "load_qc"]


@dataclass(frozen=True)
class QCStructure:
    Z: int
    mb: int  # base rows (check blocks)
    nb: int  # base cols (variable blocks)
    base: np.ndarray  # (mb, nb) int32 shifts, -1 = zero block
    # weight-2 cells (e.g. the permuted DVB-S2 standard matrix,
    # core/dvbs2.py): second shift per cell, -1 = none.  base2[i,j] >= 0
    # requires base[i,j] >= 0 and base2[i,j] != base[i,j].
    base2: np.ndarray | None = None
    # phantom completions: (j, z_v, i, z_c) edges present in the expanded
    # QC graph but ABSENT from the true matrix (the DVB-S2 staircase wrap
    # misses one entry of one circulant).  Decoders pin these edges so the
    # expanded graph decodes exactly as the true one (decoder/codec.py
    # decode_ref defines the semantics).
    phantoms: tuple = ()

    @property
    def nvar(self) -> int:
        return self.nb * self.Z

    @property
    def nchk(self) -> int:
        return self.mb * self.Z

    def circulants(self):
        """list of (i, j, s) with s >= 0, row-major order; weight-2 cells
        contribute two entries (base shift first when smaller)."""
        out = []
        for i, j in zip(*np.nonzero(self.base >= 0)):
            ss = [int(self.base[i, j])]
            if self.base2 is not None and self.base2[i, j] >= 0:
                ss.append(int(self.base2[i, j]))
            for s in sorted(ss):
                out.append((int(i), int(j), s))
        return out


def qc_expand(qc: QCStructure) -> TannerGraph:
    """Expand to a TannerGraph; the QC structure rides along as graph.qc.

    Per-node edge order is SLOT order — for variable (j, z) the checks in
    ascending (block row i, shift s); for check (i, z) the variables in
    ascending (block col j, shift s).  For weight-1-only structures this
    equals the ascending-index order of a sorted expansion (distinct block
    rows/cols order by block id), so existing codes are unchanged; for
    weight-2 cells it is the unique order that is UNIFORM in z, which the
    fused QC kernels require (fast_layout.qc_plan).  The slot order also
    fixes the LUT-tree leaf assignment per node — a realization choice
    equivalent to feeding the reference the expanded (permuted) matrix,
    reference src/LDPC_Code_LUT.cpp:488-541.

    Phantom completions (qc.phantoms) become real edges of the expanded
    graph, recorded in graph.qc_phantoms as dicts with the variable, check,
    VN-major edge id, and per-node slot positions; decoders that support
    them decode the TRUE matrix exactly (pinned-edge semantics), all others
    must reject the graph."""
    Z = qc.Z
    col_circs: list[list] = [[] for _ in range(qc.nb)]
    row_circs: list[list] = [[] for _ in range(qc.mb)]
    for i, j, s in qc.circulants():
        col_circs[j].append((i, s))
        row_circs[i].append((j, s))
    for lst in col_circs:
        lst.sort()
    for lst in row_circs:
        lst.sort()
    cols: list[np.ndarray] = []
    for j in range(qc.nb):
        rows = np.array([i for i, _ in col_circs[j]], dtype=np.int64)
        shifts = np.array([s for _, s in col_circs[j]], dtype=np.int64)
        for z in range(Z):
            cols.append((rows * Z + (z + shifts) % Z).astype(np.int64))
    g = TannerGraph.from_cols(cols, qc.nvar, qc.nchk)
    _reorder_checks_to_slot_order(g, qc, row_circs)
    g.qc = qc  # dataclass attr injection; consumers check getattr
    if qc.phantoms:
        starts = np.concatenate([[0], np.cumsum(g.dv_vec)])
        ph = []
        for (j, z_v, i, z_c) in qc.phantoms:
            v = j * Z + z_v
            c = i * Z + z_c
            s = (z_c - z_v) % Z
            k = col_circs[j].index((i, s))
            l = row_circs[i].index((j, s))
            if ((z_v + s) % Z) != z_c:
                raise ValueError("phantom not on its circulant")
            ph.append(dict(var=v, chk=c, edge=int(starts[v]) + k,
                           var_slot=k, chk_slot=l,
                           j=j, z_v=z_v, i=i, z_c=z_c))
        g.qc_phantoms = tuple(ph)
    return g


def _reorder_checks_to_slot_order(g: TannerGraph, qc: QCStructure,
                                  row_circs) -> None:
    """Reorder each check's index-array entries into slot order.

    from_cols lists a check's edges in ascending variable index; for
    weight-2 cells that order flips with z at the circulant wrap, so the
    affected checks are rewritten to ascending (block col, shift) — a pure
    relabeling of the check's socket positions (the CN update is symmetric
    in its inputs: min-sum two-min + sign parity and XOR syndrome are
    order-free), required for the per-slot DMA tables of the QC kernels."""
    Z = qc.Z
    if qc.base2 is None or not (np.asarray(qc.base2) >= 0).any():
        return
    row_of = {}
    for d in g.cn_degrees:
        for r, c in enumerate(g.cn_node_idx[int(d)]):
            row_of[int(c)] = (int(d), r)
    for i in range(qc.mb):
        lst = row_circs[i]
        if len({j for j, _ in lst}) == len(lst):
            continue  # weight-1 row: ascending-var order already slot order
        jj = np.array([j for j, _ in lst], dtype=np.int64)
        ss = np.array([s for _, s in lst], dtype=np.int64)
        for z in range(Z):
            c = i * Z + z
            want = jj * Z + (z - ss) % Z  # slot-order variable ids
            d, r = row_of[c]
            cur = g.cn_var_idx[d][r]
            order = np.array([int(np.nonzero(cur == v)[0][0]) for v in want])
            g.cn_var_idx[d][r] = cur[order]
            g.cn_edge_idx[d][r] = g.cn_edge_idx[d][r][order]


def _forbidden_shifts(base, Z, i, j, girth):
    """Residues s that would close a 4-cycle (and, for girth >= 8, a
    6-cycle) through block (i, j), given the already-assigned shifts.

    4-cycle: s == base[i2,j] - base[i2,q] + base[i,q]  (mod Z)
    6-cycle: s == base[i2,j] + (base[i3,q2] - base[i2,q2])
                           + (base[i,q3] - base[i3,q3])  (mod Z)
    over distinct rows/cols with all participating circulants assigned.
    The q2 != q3 requirement is dropped (strictly conservative: it only
    forbids extra residues, never misses a cycle)."""
    mb, nb = base.shape
    m = base.copy()
    m[:, j] = -1  # exclude column j from the cross-column differences
    forb: set[int] = set()

    col_j = base[:, j]
    rows2 = [i2 for i2 in range(mb) if i2 != i and col_j[i2] >= 0]
    # pairwise difference sets D[a, b] = {base[a,q] - base[b,q]} over
    # columns q != j where both are assigned
    both = (m >= 0)

    def diffs(a, b):
        q = both[a] & both[b]
        return (m[a, q] - m[b, q]) if q.any() else np.zeros(0, dtype=np.int64)

    for i2 in rows2:
        # 4-cycles through (i, j) and (i2, j)
        d = diffs(i, i2)  # base[i,q] - base[i2,q]
        if d.size:
            forb.update(((col_j[i2] + d) % Z).tolist())
        if girth < 8:
            continue
        for i3 in range(mb):
            if i3 == i or i3 == i2:
                continue
            d2 = diffs(i3, i2)  # base[i3,q2] - base[i2,q2]
            d3 = diffs(i, i3)  # base[i,q3] - base[i3,q3]
            if d2.size and d3.size:
                vals = (col_j[i2] + d2[:, None] + d3[None, :]) % Z
                forb.update(vals.ravel().tolist())
    return forb


def qc_generate_regular(dv: int, dc: int, Z: int, nb: int,
                        seed: int = 1, girth: int = 8,
                        shift_step: int = 1) -> QCStructure:
    """Regular (dv, dc) QC code: nb variable blocks, mb = nb*dv/dc check
    blocks, all-weight-1 circulants, greedy girth-conditioned shifts.

    shift_step restricts shifts to multiples of the step.  WARNING: with
    step > 1 and step | Z, z mod step is invariant along every edge, so
    the expanded graph decomposes into `step` disconnected length-N/step
    subcodes with correspondingly worse waterfalls — decoder/qc_kernels.py
    handles arbitrary shifts (aligned-window DMA + realign slice), so
    there is no reason to use step != 1."""
    if (nb * dv) % dc:
        raise ValueError("nb*dv must be divisible by dc")
    mb = nb * dv // dc
    rng = np.random.default_rng(seed)

    # balanced base graph: each col picks dv distinct rows, each row ends
    # with exactly dc cols (configuration-model with retries)
    for _ in range(10000):
        slots = rng.permutation(np.repeat(np.arange(mb), dc))
        cols_rows = slots.reshape(nb, dv)
        if all(len(set(r)) == dv for r in cols_rows):
            break
    else:  # deterministic fallback: cyclic row assignment
        cols_rows = np.array(
            [[(j + k * (mb // dv if mb % dv else mb // dv)) % mb
              for k in range(dv)] for j in range(nb)]
        )
    base = np.full((mb, nb), -1, dtype=np.int64)
    order = [(int(r), j) for j in range(nb) for r in cols_rows[j]]
    if Z % shift_step:
        raise ValueError("shift_step must divide Z")
    cand_all = range(0, Z, shift_step)
    relaxed = 0
    for i, j in order:
        forb = _forbidden_shifts(base, Z, i, j, girth)
        allowed = [s for s in cand_all if s not in forb]
        if not allowed and girth >= 8:  # relax this circulant to girth 6
            forb = _forbidden_shifts(base, Z, i, j, 6)
            allowed = [s for s in cand_all if s not in forb]
            relaxed += 1
        if not allowed:
            raise RuntimeError(
                f"no 4-cycle-free shift at block ({i},{j}); increase Z"
            )
        base[i, j] = int(rng.choice(allowed))
    qc = QCStructure(Z=Z, mb=mb, nb=nb, base=base.astype(np.int64))
    object.__setattr__(qc, "relaxed_circulants", relaxed)
    return qc


def _largest_remainder(fracs: np.ndarray, total: int) -> np.ndarray:
    """Integer counts summing to `total`, proportional to fracs."""
    raw = np.asarray(fracs, dtype=np.float64) * total
    cnt = np.floor(raw).astype(np.int64)
    order = np.argsort(-(raw - cnt))
    for k in range(int(total - cnt.sum())):
        cnt[order[k % len(cnt)]] += 1
    return cnt


def _fit_row_counts(degrees, node_fracs, edges: int,
                    mb_fixed: int | None = None):
    """Row-block degree counts c_d >= 0 with sum(c_d * d) == edges, as close
    to the node-perspective check distribution as integer blocks allow.
    Returns (mb, counts).  Raises when no active-degree assignment exists."""
    degrees = np.asarray(degrees, dtype=np.int64)
    mean_dc = float(np.dot(degrees, node_fracs))
    mb = int(round(edges / mean_dc))
    lo = -(-edges // int(degrees.max()))  # ceil
    hi = edges // int(degrees.min())
    if mb_fixed is not None:
        lo = hi = mb = int(mb_fixed)
    if lo > hi:
        raise ValueError("qc_generate_irregular: no feasible check-block count")
    mb = min(max(mb, lo), hi)
    for mb_try in sorted(range(lo, hi + 1), key=lambda m: abs(m - mb)):
        cnt = _largest_remainder(np.asarray(node_fracs), mb_try)
        # repair the edge sum by unit moves between degree classes
        for _ in range(10000):
            diff = edges - int(np.dot(cnt, degrees))
            if diff == 0:
                return mb_try, cnt
            moved = False
            for a in range(len(degrees)):
                for b in range(len(degrees)):
                    step = int(degrees[b] - degrees[a])
                    if step == 0 or cnt[a] == 0:
                        continue
                    if (diff > 0 and 0 < step <= diff) or (
                        diff < 0 and 0 > step >= diff
                    ):
                        cnt[a] -= 1
                        cnt[b] += 1
                        moved = True
                        break
                if moved:
                    break
            if not moved:
                break
    raise ValueError("qc_generate_irregular: check degrees cannot hit the "
                     "edge count")


def qc_generate_irregular(ensemble, Z: int, nb: int, seed: int = 1,
                          girth: int = 8, mb: int | None = None
                          ) -> QCStructure:
    """Irregular QC code matching an ensemble's degree distributions.

    The node-perspective VN/CN distributions are quantized to multiples of
    1/nb (largest-remainder), every circulant has weight 1, and each
    variable block's circulants live in DISTINCT check blocks — so the
    expanded graph's per-column sorted check order equals the circulant
    (check-block) order uniformly in z, which is what lets the decoder
    replace its permutation gathers with per-circulant cyclic rolls
    (fast_layout.GroupedLayout.qc_plan).  Shifts are greedy-random
    under the Fossorier cycle conditions (girth 8 with per-circulant
    relaxation to 6, as in qc_generate_regular).

    The LUT design path is unchanged: LUTs depend only on the (empirical)
    ensemble and design sigma (reference src/LDPC_Code_LUT.cpp:699),
    exactly as with the reference's unstructured PEG construction
    (reference peg/BigGirth.C)."""
    rng = np.random.default_rng(seed)
    cnt_v = _largest_remainder(ensemble.Lam_node(), nb)
    dvs = np.asarray(ensemble.degree_lam, dtype=np.int64)
    dcs = np.asarray(ensemble.degree_rho, dtype=np.int64)
    edges = int(np.dot(cnt_v, dvs))
    mb, cnt_c = _fit_row_counts(dcs, ensemble.Rho_node(), edges, mb_fixed=mb)
    if int(dvs.max()) > mb:
        raise ValueError(
            f"max VN degree {int(dvs.max())} exceeds {mb} check blocks; "
            "increase nb (distinct check blocks per variable block required)"
        )

    # base bipartite graph: column degrees d_j, row capacities dc_i, no
    # multi-edges.  Gale-Ryser greedy (highest remaining capacity first)
    # is guaranteed to succeed when the degree sequence is feasible;
    # random keys break capacity ties for construction diversity.
    col_deg = np.repeat(dvs, cnt_v)
    row_cap = np.repeat(dcs, cnt_c)
    perm_v = rng.permutation(nb)  # interleave degree classes spatially
    cap = row_cap.astype(np.int64).copy()
    base = np.full((mb, nb), -1, dtype=np.int64)
    picks: dict[int, np.ndarray] = {}
    for j in perm_v[np.argsort(-col_deg[perm_v], kind="stable")]:
        d = int(col_deg[j])
        key = cap + rng.random(mb)  # random tie-break within equal capacity
        rows = np.argsort(-key, kind="stable")[:d]
        if cap[rows].min() <= 0:
            raise ValueError("qc_generate_irregular: infeasible degree "
                             "sequence (row capacity exhausted)")
        cap[rows] -= 1
        picks[int(j)] = np.sort(rows)
    if cap.max() != 0:
        raise ValueError("qc_generate_irregular: unassigned check sockets")

    # greedy girth-conditioned shifts, hardest (highest-degree) columns first
    relaxed = 0
    for j in perm_v[np.argsort(-col_deg[perm_v], kind="stable")]:
        for i in picks[int(j)]:
            forb = _forbidden_shifts(base, Z, int(i), int(j), girth)
            allowed = [s for s in range(Z) if s not in forb]
            if not allowed and girth >= 8:
                forb = _forbidden_shifts(base, Z, int(i), int(j), 6)
                allowed = [s for s in range(Z) if s not in forb]
                relaxed += 1
            if not allowed:
                raise RuntimeError(
                    f"no 4-cycle-free shift at block ({i},{j}); increase Z"
                )
            base[i, j] = int(rng.choice(allowed))
    qc = QCStructure(Z=Z, mb=mb, nb=nb, base=base)
    object.__setattr__(qc, "relaxed_circulants", relaxed)
    return qc


def save_qc(path: str, qc: QCStructure) -> None:
    d = {"Z": qc.Z, "mb": qc.mb, "nb": qc.nb, "base": qc.base.tolist()}
    if qc.base2 is not None:
        d["base2"] = np.asarray(qc.base2).tolist()
    if qc.phantoms:
        d["phantoms"] = [list(p) for p in qc.phantoms]
    with open(path, "w") as f:
        json.dump(d, f)


def load_qc(path: str) -> QCStructure:
    with open(path) as f:
        d = json.load(f)
    base2 = (np.asarray(d["base2"], dtype=np.int64)
             if "base2" in d else None)
    phantoms = tuple(tuple(int(x) for x in p)
                     for p in d.get("phantoms", ()))
    return QCStructure(Z=int(d["Z"]), mb=int(d["mb"]), nb=int(d["nb"]),
                       base=np.asarray(d["base"], dtype=np.int64),
                       base2=base2, phantoms=phantoms)
