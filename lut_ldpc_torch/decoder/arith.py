"""Arithmetic (value-domain) representation of a designed LUT decoder.

The MI-optimal quantizer (quant_mi_sym, reference src/common.cpp:230)
assigns output labels by *contiguous intervals in sorted joint-LLR order*,
and the joint LLR of independent inputs is the SUM of per-input LLRs.  Every
designed VN-tree node is therefore exactly representable as

    out_label = #{ k : v_a[a] + v_b[b] >= thr_k }

with per-input value tables v (the design-time LLRs of the child pmfs) and
K-1 thresholds — i.e. add + threshold-count, no table lookup.  Carrying
*values* instead of labels through the whole decoder turns message passing
into pure vector arithmetic (the TPU's VPU sweet spot) and eliminates the
per-element gathers that dominate a table-based decoder on TPU:

- a message's value encodes its label via a strictly monotone symmetric map,
  so the integer min-LUT CN update (sign parity + two-min on magnitude
  labels, LDPC_Code_LUT.cpp:355-402) becomes sign/abs/min arithmetic on
  values with bit-identical label semantics;
- each tree node emits the value its *consumer* expects (the parent's child
  LLR table, or for roots the next iteration's leaf LLR table), so no
  label->value conversion is ever needed mid-stream.

EXACTNESS IS VERIFIED, NOT ASSUMED: every node's arithmetic form is
validated exhaustively against its integer LUT over all input combinations
(in float32, with the runtime's accumulation order), and the value<->label
monotonicity/symmetry conditions required by the CN update are checked per
iteration.  Any violation raises, and callers fall back to the table-based
decoder — the arithmetic path is a provably-equivalent acceleration, never
an approximation.

Built from the codec's design-time pmf snapshots (pmf_cha_design,
pmf_chk2var_trace) by replaying each iteration's tree update.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .codec import LUTCodec
from .layout import _var_full_table

__all__ = ["ArithSpec", "ArithTreeSpec", "ArithOpSpec", "build_arith_spec", "nudged_llr"]


def nudged_llr(p: np.ndarray, tiny: float = 1e-6) -> np.ndarray:
    """Finite, antisymmetric, sign-correct value table for a symmetric pmf.

    v[x] = llr(x) with zero-mass and zero-LLR labels nudged to tiny values
    whose sign matches the label's half (label < K/2 <=> v < 0), and
    infinities clipped to distinct large finite values.  float64.
    """
    p = np.asarray(p, dtype=np.float64)
    K = len(p)
    with np.errstate(divide="ignore", invalid="ignore"):
        l = np.log(p) - np.log(p[::-1])
    center = (K - 1) / 2.0
    offsets = np.arange(K) - center  # antisymmetric, sign matches half
    # both-zero pairs: 0/0 -> NaN
    nan_mask = np.isnan(l)
    l[nan_mask] = tiny * offsets[nan_mask]
    finite = np.isfinite(l)
    big = (np.abs(l[finite]).max() if finite.any() else 0.0) + 10.0
    l[np.isposinf(l)] = big + tiny * np.arange(K)[np.isposinf(l)]
    l[np.isneginf(l)] = -(big + tiny * np.arange(K)[::-1][np.isneginf(l)])
    v = 0.5 * (l - l[::-1])  # exact antisymmetry
    zero = v == 0.0
    v[zero] = tiny * offsets[zero]
    return v


@dataclass(frozen=True)
class ArithOpSpec:
    """One tree node: sum operand values, emit piecewise-constant output.

    operands: slots into the evaluation value list (leaves in DFS order
    first, then op outputs).  Output = levels[#thresholds crossed], emitted
    via a sequential select chain so values are exact (no accumulation
    error); thresholds has length K-1 (dtype-max for unreachable upper
    levels).  Works in float32 or int16 (scaled-integer values).

    Zero-sum tie-break: input combinations whose values cancel exactly
    (mirror pairs through antisymmetric tables) are split by the design's
    stable sort on the joint label index — equivalently by the sign of the
    most-significant child's value — so a sum of exactly 0 emits tie_lo
    (last operand negative) or tie_hi.  Exactness is validated exhaustively.

    Symmetric factorization (sym_thr/sym_levels, set when it validates):
    designed LUTs are antisymmetric (half-LUT mirror, LUT_Tree.cpp:414-417),
    so the emission usually factors as out = sign(s) * sym_levels[c] with
    c = #{t : |s| >= sym_thr[t]} — HALF the thresholds of the full chain
    ((K/2)-1 instead of K-1).  Like everything else here this is verified
    exhaustively over the reachable sums (label equality against the LUT),
    never assumed; consumers fall back to the full chain when absent.
    has_zero records whether any reachable combination sums to exactly 0
    (when False consumers may skip the tie select entirely).
    """

    operands: tuple
    thresholds: np.ndarray  # (K-1,) work dtype
    levels: np.ndarray  # (K,) work dtype: emitted values per output label
    tie_lo: float  # emitted at sum==0 with last operand < 0
    tie_hi: float  # emitted at sum==0 with last operand > 0
    sym_thr: np.ndarray | None = None  # (K/2-1,) magnitude thresholds
    sym_levels: np.ndarray | None = None  # (K/2,) magnitude levels
    has_zero: bool = True  # a reachable zero sum exists (tie can fire)
    # inside an int16 spec, an op touched by the center-pair repair carries
    # float32 parameters and float32 arithmetic (its values live only in
    # registers/VMEM — message STORAGE stays int16); consumers must then
    # evaluate the whole tree in float32 (exact on the int16 grid)
    float_params: bool = False


@dataclass(frozen=True)
class ArithTreeSpec:
    num_inputs: int  # leaves in DFS order; channel leaf is one of them
    ops: tuple  # topological; last op is the root

    def structure_key(self):
        return (self.num_inputs, tuple(op.operands for op in self.ops))

    def eval_np(self, x: np.ndarray) -> np.ndarray:
        """x (..., num_inputs) in the work dtype -> (...,) root output.

        Mirrors the validated runtime arithmetic PER OP: integer ops in
        int64 (exact int16 adds), float ops — all ops of float32 specs,
        plus float_params ops inside int16 specs (center-pair repair) — in
        float32 chained adds."""
        vals = [np.asarray(x[..., i]) for i in range(self.num_inputs)]
        for op in self.ops:
            wide = (np.int64 if np.issubdtype(op.thresholds.dtype, np.integer)
                    else np.float32)
            s = vals[op.operands[0]].astype(wide)
            for sl in op.operands[1:]:
                s = s + vals[sl].astype(wide)
            lv = op.levels.astype(wide)
            out = np.full(s.shape, lv[0], dtype=wide)
            for k in range(len(op.thresholds)):
                out = np.where(s >= wide(op.thresholds[k]), lv[k + 1], out)
            tie = np.where(vals[op.operands[-1]].astype(wide) < 0,
                           op.tie_lo, op.tie_hi)
            out = np.where(s == 0, tie.astype(wide), out)
            vals.append(out)
        return vals[-1]


@dataclass
class ArithSpec:
    """Everything the arithmetic decoder needs.

    var_trees[it][degree_index]: ArithTreeSpec for VN iterations
    0..num_iters-1 (roots emit next-iteration leaf values);
    dec_trees[degree_index] for the decision pass (None when the spec is a
    truncated prefix).  leaf_msg0 / leaf_cha are label->value tables for
    the initial messages and the channel leaves.  num_iters counts the VN
    iterations covered; a prefix spec (num_iters < codec.max_iters - 1 or
    dec_trees None) supports unanimity-exit decoding of the first
    num_iters iterations only.
    """

    var_trees: list
    dec_trees: list | None
    leaf_msg0: np.ndarray  # (Nq,) work dtype
    leaf_cha: np.ndarray  # (Nq_Cha,) work dtype
    degrees: list  # VN degrees, index-aligned with the tree lists
    num_iters: int = 0
    dtype: object = np.float32  # message/value dtype (float32 or int16)

    def __post_init__(self):
        if not self.num_iters:
            self.num_iters = len(self.var_trees)


class ArithBuildError(ValueError):
    pass


def loo_msg_spans(struct: ArithTreeSpec):
    """Per-op (lo, hi) inclusive span of MESSAGE leaf positions under the
    op (None when the op sees only the channel leaf), for the shared-sweep
    leave-one-out evaluation.

    A VN tree has d-1 message leaves at DFS positions 0..d-2 plus the
    channel leaf DFS-last.  The leave-one-out output that excludes message
    i assigns position j the message j (j < i) or j+1 (j >= i), so every
    sub-tree whose message span lies fully below i equals its value under
    the IDENTITY assignment and every sub-tree fully at/above i equals its
    value under the SHIFT-BY-ONE assignment: two bottom-up sweeps plus the
    per-output straddle path replace the d independent tree evaluations
    (d*(d-1) op evals -> 2*(d-1) + sum_i |ancestors(i)|)."""
    n_in = struct.num_inputs
    spans = []
    for op in struct.ops:
        lo, hi = None, None
        for x in op.operands:
            if x < n_in - 1:  # message leaf position
                s = (x, x)
            elif x == n_in - 1:  # channel leaf: identical in both sweeps
                continue
            else:
                s = spans[x - n_in]
                if s is None:
                    continue
            lo = s[0] if lo is None else min(lo, s[0])
            hi = s[1] if hi is None else max(hi, s[1])
        spans.append(None if lo is None else (lo, hi))
    return spans


def _joint_mask(child_masks):
    """Flattened reachability mask over joint labels (child 0 least
    significant — the same label convention as the joint sums)."""
    mask = np.ones(1, dtype=bool)
    for mm in child_masks:
        mask = (np.asarray(mm, bool)[:, None] & mask[None, :]).reshape(-1)
    return mask


def _node_image(node, table, child_masks):
    """Output labels this node can actually emit: the image of its LUT on
    the reachable input combinations."""
    img = np.zeros(node.K, dtype=bool)
    img[np.unique(table[_joint_mask(child_masks)])] = True
    return img | img[::-1]  # CN sign flips keep label sets symmetric


def clamp_dead(v: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Replace values of unreachable labels by tight monotone fillers.

    Unreachable labels never occur at runtime (they are outside the image
    of every producing LUT), so their values are free; the nudged LLRs of
    dead labels in late DE iterations otherwise blow up the int16 scaling
    range and break sum-monotonicity.  Keeps strict |v| monotonicity and
    exact antisymmetry."""
    v = np.asarray(v, dtype=np.float64).copy()
    mask = np.asarray(mask, bool)
    if mask.all():
        return v
    K = len(v)
    nz = K // 2
    up = v[nz:].copy()
    m = mask[nz:]
    prev = None
    for i in range(len(up)):
        if m[i]:
            prev = up[i]
        else:
            up[i] = 1e-9 if prev is None else prev * (1 + 1e-6) + 1e-9
            prev = up[i]
    v[nz:] = up
    v[:nz] = -up[::-1]
    return v


def compute_reachable(codec) -> list:
    """Exact per-iteration reachable message-label masks.

    A label can enter iteration ii iff some reachable input combination of
    an iteration ii-1 VN tree emits it (pure LUT-image propagation — no
    probabilities, so float-underflowed-but-possible labels are never
    misclassified as dead).  The min-sum CN pass maps any symmetric label
    set to itself (output magnitude is one of the input magnitudes, signs
    are free), and every mask here is symmetric, so CN adds nothing.
    Iteration 0 messages come straight from the channel quantizer; all
    labels are assumed reachable there (a sound upper bound)."""
    from ..core.trees import CHA, MSG

    T = codec.max_iters
    K = int(codec.Nq_Msg[0])
    Kc = int(codec.Nq_Cha)
    cha_mask = np.ones(Kc, dtype=bool)
    reach = [np.ones(K, dtype=bool)]

    def walk(n, msg_mask):
        if n.type == CHA:
            return cha_mask
        if n.type == MSG:
            return msg_mask
        masks = [walk(c, msg_mask) for c in n.children]
        L = int(np.prod([len(m) for m in masks]))
        table = _var_full_table(np.asarray(n.Q), L, n.K).astype(np.int64)
        return _node_image(n, table, masks)

    for ii in range(1, T):
        cur = np.zeros(K, dtype=bool)
        for d in codec.var_tree_degrees:
            cur |= walk(codec.var_tree(ii - 1, int(d)).root, reach[ii - 1])
        reach.append(cur | cur[::-1])
    return reach


def _tree_values(node, leaf_msg, leaf_cha, convert, msg_mask, cha_mask):
    """Post-order walk computing each node's input value tables (through
    `convert`, which maps f64 LLR tables to the work dtype) and reachable
    label masks; returns (node, slots, child_tables, child_masks) tuples in
    topological order plus leaf count."""
    from ..core.trees import CHA, MSG

    ops = []
    leaf_count = 0
    num_leaves = node.num_leaves()

    def rec(n):
        nonlocal leaf_count
        if n.type in (MSG, CHA):
            slot = leaf_count
            leaf_count += 1
            table = leaf_cha if n.type == CHA else leaf_msg
            mask = cha_mask if n.type == CHA else msg_mask
            if len(table) != n.K:
                raise ArithBuildError(
                    f"leaf resolution {n.K} != value table {len(table)}"
                )
            return slot, table, mask, None
        triples = [rec(c) for c in n.children]
        slots = tuple(p[0] for p in triples)
        tables = [p[1] for p in triples]
        masks = [p[2] for p in triples]
        L = int(np.prod([len(t) for t in tables]))
        lut = _var_full_table(np.asarray(n.Q), L, n.K).astype(np.int64)
        img = _node_image(n, lut, masks)
        out_f64 = clamp_dead(nudged_llr(n.p), img)
        ops.append((n, slots, tables, masks, out_f64))
        return num_leaves + len(ops) - 1, convert(out_f64), img, out_f64

    rec(node)
    return ops, leaf_count


def _op_spec(node, slots, child_tables, child_masks, out_values,
             work_dtype, float_arith: bool = False) -> ArithOpSpec:
    """Derive thresholds for one node and validate exhaustively against its
    integer LUT in the runtime's arithmetic (float32 chained adds, or exact
    integer adds range-checked against int16).

    float_arith=True (int16 specs only): validate this op in float32
    arithmetic with float32 parameters — used for ops whose input tables
    were forked off the integer grid by the center-pair repair.  The op's
    emitted values (out_values) stay on the caller's grid; only the op's
    own thresholds/arithmetic go float.

    Only *reachable* input combinations participate (child_masks from the
    exact LUT-image propagation): unreachable combos cannot occur at
    runtime, so the sum representation need not — and in degenerate late
    iterations cannot — reproduce the LUT's don't-care entries there."""
    if float_arith:
        work_dtype = np.float32
    is_int = np.issubdtype(np.dtype(work_dtype), np.integer)
    wide = np.int64 if is_int else np.float32
    ks = [len(t) for t in child_tables]
    L = int(np.prod(ks))
    K = node.K
    if node.Q is None or len(node.Q) != L // 2:
        raise ArithBuildError("node LUT missing or wrong length")
    table = _var_full_table(np.asarray(node.Q), L, K).astype(np.int64)
    live = _joint_mask(child_masks)
    if not live.any():
        raise ArithBuildError("no reachable input combinations")

    # joint sums indexed by label = l_0 + K0*l_1 + ... (child 0 least
    # significant, same convention as the LUT tables); dtype mirrors the
    # runtime arithmetic exactly
    s = np.zeros(1, dtype=wide)
    for t in child_tables:
        s = (t.astype(wide)[:, None] + s[None, :]).reshape(-1)
    if is_int and np.abs(s[live]).max() > 32600:
        raise ArithBuildError("int16 sum range exceeded")

    # zero-sum ties resolve by the most-significant child's value sign (the
    # design's stable index sort splits exact-zero-LLR joint labels by
    # index half); those combos get the explicit tie outputs
    last = child_tables[-1].astype(wide)
    tie_val = np.repeat(last, L // ks[-1])
    if is_int and np.any(last[np.asarray(child_masks[-1], bool)] == 0):
        raise ArithBuildError("zero entry in integer value table")
    zero = (s == 0) & live
    out_values = np.asarray(out_values, dtype=work_dtype)
    if len(out_values) != K:
        raise ArithBuildError("output value table length mismatch")
    lo_set = np.unique(table[zero & (tie_val < 0)])
    hi_set = np.unique(table[zero & (tie_val > 0)])
    if len(lo_set) > 1 or len(hi_set) > 1:
        raise ArithBuildError("zero-sum ties map to multiple output labels")
    tie_lo = out_values[lo_set[0]] if len(lo_set) else out_values[0]
    tie_hi = out_values[hi_set[0]] if len(hi_set) else out_values[0]

    nz = live & (s != 0)
    thr_inf = np.asarray(32767 if is_int else np.inf, dtype=work_dtype)
    thr = np.full(K - 1, thr_inf, dtype=work_dtype)
    for k in range(1, K):
        ge = s[nz & (table >= k)]
        if len(ge):
            thr[k - 1] = ge.min().astype(work_dtype)

    # exhaustive validation: piecewise level == table level for all
    # reachable non-tie combos (tie combos validated through lo/hi above)
    lvl = np.zeros(L, dtype=np.int64)
    for k in range(K - 1):
        lvl += (s >= thr[k].astype(wide)).astype(np.int64)
    if not np.array_equal(lvl[nz], table[nz]):
        raise ArithBuildError("arithmetic form does not reproduce the LUT")

    # symmetric factorization (see ArithOpSpec): validated exhaustively —
    # label(s>0) == K/2 + c(|s|), label(s<0) == K/2-1 - c(|s|) with
    # c(m) = #{t : m >= thr[K/2 + t]}, and antisymmetric levels so
    # levels[K/2-1-c] == -levels[K/2+c]
    sym_thr = sym_lev = None
    if K % 2 == 0:
        half = K // 2
        lv_w = out_values.astype(wide)
        if np.array_equal(lv_w, -lv_w[::-1]):
            thr_hi = thr[half:]
            sn, mn = s[nz], np.abs(s[nz])
            c = np.zeros(len(sn), dtype=np.int64)
            for t in range(len(thr_hi)):
                c += (mn >= thr_hi[t].astype(wide)).astype(np.int64)
            pred = np.where(sn > 0, half + c, half - 1 - c)
            if np.array_equal(pred, table[nz]):
                sym_thr = thr_hi.copy()
                sym_lev = out_values[half:].copy()
    return ArithOpSpec(slots, thr, out_values, float(tie_lo), float(tie_hi),
                       sym_thr=sym_thr, sym_levels=sym_lev,
                       has_zero=bool(zero.any()), float_params=float_arith)


def _dfs_leaf_types(node, out):
    from ..core.trees import CHA, MSG

    if node.type in (MSG, CHA):
        out.append(node.type)
    for c in node.children:
        _dfs_leaf_types(c, out)
    return out


def _repair_center_candidates(v0, v1, table, live, nz):
    """Candidate (new v0, new v1) pairs for the noise-center tie conflict.

    Applies when both children's center pair (labels nz-1, nz) carries
    pure log-noise values (|v| ~ 1e-16) whose signs encode the design's
    stable-sort order rather than the label halves.  The designed LUT is
    then NON-monotone in the child labels near zero — e.g. the diagonal
    cluster maps (nz-1, nz-1) ABOVE the antidiagonal ties while
    (nz, nz) maps below — which no threshold-of-sum with *shared* child
    tables can express.  It IS expressible with per-child freedom:

    - scale child 1's non-center entries by (1 + delta): the exact
      antidiagonal ties v0[l] + v1[K-1-l] == 0 become -delta*v1[l],
      i.e. strictly ordered by child-1 label — the joint-index order of
      the design's stable sort;
    - give the centers distinct power-of-two magnitudes (a for child 0,
      b for child 1) solving the 2x2 cluster's linear constraints; which
      sign pattern is consistent depends on which side of the boundary
      the design's noise put the diagonal entries, so several candidates
      are returned and the caller keeps the first whose op validates
      exhaustively (exactness is never assumed).

    delta is bounded by the smallest label-boundary gap so no non-tie
    combo can cross a threshold; u is a power of two so all cluster sums
    (+-u, +-2u, +-3u) are exact in float32."""
    big0 = np.abs(np.concatenate([v0[:nz - 1], v0[nz + 1:]]))
    big1 = np.abs(np.concatenate([v1[:nz - 1], v1[nz + 1:]]))
    c_min = min(big0.min(), big1.min())
    c_max = max(np.abs(v0).max(), np.abs(v1).max())
    if c_min <= 0:
        return []
    # smallest gap between adjacent distinct sums across a label boundary,
    # measured on the unrepaired sums (zero-cluster excluded)
    # joint label convention l0 + K0*l1 (child 0 least significant), the
    # same order as `table` and `live`
    s = (v1[:, None] + v0[None, :]).reshape(-1)
    lab = table
    nzmask = live & (np.abs(s) > 1e-9)
    gap = np.inf
    for k in range(int(lab[live].max())):
        lo = s[nzmask & (lab <= k)]
        hi = s[nzmask & (lab > k)]
        if len(lo) and len(hi):
            g = hi.min() - lo.max()
            if g > 0:
                gap = min(gap, g)
    if not np.isfinite(gap):
        gap = c_min
    delta = min(2.0 ** -12, gap / (8.0 * c_max))
    if delta < 1e-7:  # below float32 resolution of the scaled entries
        return []
    u = 2.0 ** np.floor(np.log2(delta * c_min / 16.0))
    if u <= 0 or not np.isfinite(u):
        return []

    def build(a, b):
        w0 = v0.copy()
        w1 = v1.copy()
        w1[:nz - 1] *= (1.0 + delta)
        w1[nz + 1:] *= (1.0 + delta)
        w0[nz], w0[nz - 1] = a, -a
        w1[nz], w1[nz - 1] = b, -b
        return w0, w1

    out = []
    for a, b in ((-2 * u, u), (-u, 2 * u), (u, -2 * u), (2 * u, -u),
                 (u, 2 * u), (2 * u, u)):
        out.append(build(a, b))
    return out


def _try_repair(node, slots, masks, emit_f64, out_vals, work_dtype,
                num_leaves) -> dict | None:
    """Attempt the center-pair repair for a failing 2-child op whose
    children are both interior ops.  Returns {slot: new float32 table} on
    success (the repaired op validates exhaustively), None otherwise.

    The candidate tables are built from the children's f64 pre-conversion
    LLR tables: the noise-center precondition (|center| ~ 1e-16) is only
    visible there — an integer grid rounds the noise centers to +-1.  In
    int16 specs the repaired tables simply live off the integer grid and
    the affected ops carry float32 parameters (float_params); message
    STORAGE is untouched because only interior op tables are forked."""
    if len(slots) != 2 or any(s < num_leaves for s in slots):
        return None  # leaf tables are shared across slots; cannot fork them
    if slots[0] not in emit_f64 or slots[1] not in emit_f64:
        return None
    float_arith = np.issubdtype(np.dtype(work_dtype), np.integer)
    v0 = np.asarray(emit_f64[slots[0]], dtype=np.float64)
    v1 = np.asarray(emit_f64[slots[1]], dtype=np.float64)
    if len(v0) != len(v1):
        return None
    K0 = len(v0)
    nz = K0 // 2
    tol = 1e-9
    if max(abs(v0[nz]), abs(v0[nz - 1]), abs(v1[nz]), abs(v1[nz - 1])) > tol:
        return None
    L = K0 * len(v1)
    table = _var_full_table(np.asarray(node.Q), L, node.K).astype(np.int64)
    live = _joint_mask(masks)
    for w0, w1 in _repair_center_candidates(v0, v1, table, live, nz):
        t0 = np.asarray(w0, dtype=np.float32)
        t1 = np.asarray(w1, dtype=np.float32)
        try:
            _op_spec(node, slots, [t0, t1], masks, out_vals, work_dtype,
                     float_arith=float_arith)
        except ArithBuildError:
            continue
        return {slots[0]: t0, slots[1]: t1}
    return None


def _build_tree_spec(tree, leaf_msg, leaf_cha, root_out_values,
                     convert, work_dtype, msg_mask=None,
                     cha_mask=None) -> ArithTreeSpec:
    from ..core.trees import CHA, MSG

    # the runtime feeds the channel value into the LAST queue slot
    # (var_msg_update appends llr to the deque), so the arithmetic form is
    # only consistent when the CHA-typed leaf is DFS-last
    types = _dfs_leaf_types(tree.root, [])
    if types[-1] != CHA or any(t != MSG for t in types[:-1]):
        raise ArithBuildError("channel leaf must be the last DFS leaf")
    if msg_mask is None:
        msg_mask = np.ones(len(leaf_msg), dtype=bool)
    if cha_mask is None:
        cha_mask = np.ones(len(leaf_cha), dtype=bool)
    ops_raw, num_inputs = _tree_values(tree.root, leaf_msg, leaf_cha,
                                       convert, msg_mask, cha_mask)
    is_int = np.issubdtype(np.dtype(work_dtype), np.integer)
    # current emitted value table per slot (leaves, then op outputs);
    # the repair path may fork an op's emitted table away from its
    # sibling's even when their pmfs are identical.  emit_f64 keeps the
    # pre-conversion f64 LLR tables of interior slots (the repair's
    # noise-center precondition is only visible there); float_slots marks
    # slots whose tables were forked off the integer grid — ops consuming
    # them validate and run in float32 (float_params).
    emit = {}
    emit_f64 = {}
    float_slots: set = set()
    for node, slots, tables, masks, _f64 in ops_raw:
        for s, t in zip(slots, tables):
            emit.setdefault(s, t)
    out_tables = []  # per op: its emitted table (out_vals)
    specs = []
    for i, (node, slots, tables, masks, out_f64) in enumerate(ops_raw):
        is_root = i == len(ops_raw) - 1
        if is_root:
            out_vals = root_out_values
        else:
            out_vals = convert(out_f64)[: node.K]
        child_tabs = [emit[s] for s in slots]
        fa = is_int and any(s in float_slots for s in slots)
        try:
            spec = _op_spec(node, slots, child_tabs, masks, out_vals,
                            work_dtype, float_arith=fa)
        except ArithBuildError:
            repaired = _try_repair(node, slots, masks, emit_f64, out_vals,
                                   work_dtype, num_inputs)
            if repaired is None:
                raise
            for s, t in repaired.items():
                emit[s] = t
                if is_int:
                    float_slots.add(s)
                j = s - num_inputs  # rebuild the child: new emitted levels
                cn, cs, _t, cm, _f = ops_raw[j]
                specs[j] = _op_spec(cn, cs, [emit[x] for x in cs], cm, t,
                                    work_dtype, float_arith=is_int)
                out_tables[j] = t
            spec = _op_spec(node, slots, [emit[s] for s in slots], masks,
                            out_vals, work_dtype, float_arith=is_int)
        specs.append(spec)
        out_tables.append(out_vals)
        emit[num_inputs + i] = out_vals
        if not is_root:
            emit_f64[num_inputs + i] = out_f64[: node.K]
    return ArithTreeSpec(num_inputs=num_inputs, ops=tuple(specs))


def _int_table(v: np.ndarray, scale: float) -> np.ndarray:
    """Round a f64 LLR table to scaled int16 grid, keeping antisymmetry and
    zero-freeness (zeros nudged to +-1 by label half)."""
    K = len(v)
    q = np.round(np.asarray(v, dtype=np.float64) * scale)
    q = 0.5 * (q - q[::-1])  # exact antisymmetry (halves stay integral or .5)
    q = np.trunc(q) + np.sign(q) * (np.abs(q - np.trunc(q)) >= 0.5)
    z = q == 0
    half = np.arange(K) >= K // 2
    q[z] = np.where(half[z], 1.0, -1.0)
    if np.abs(q).max() > 32600:
        raise ArithBuildError("int16 table range exceeded")
    return q.astype(np.int16)


def _int_repair(q: np.ndarray) -> np.ndarray:
    """Strict magnitude monotonicity for an int16 message value table."""
    q = q.astype(np.int64).copy()
    K = len(q)
    nz = K // 2
    up = q[nz:]
    prev = max(int(up[0]), 1)
    up[0] = prev
    for i in range(1, len(up)):
        if up[i] <= prev:
            up[i] = prev + 1
        prev = int(up[i])
    q[nz:] = up
    q[:nz] = -up[::-1]
    if np.abs(q).max() > 32600:
        raise ArithBuildError("int16 repair exceeded range")
    return q.astype(np.int16)


def _dtype_ctx(dtype, leaf_tables_f64):
    """(convert fn, work dtype, converted leaf tables) for a value dtype."""
    if np.dtype(dtype) == np.int16:
        maxv = max(float(np.abs(t).max()) for t in leaf_tables_f64)
        scale = 32000.0 / (4.0 * maxv)
        convert = lambda v: _int_table(v, scale)
        leaves = [_int_repair(_int_table(t, scale)) for t in leaf_tables_f64]
        return convert, np.int16, leaves
    convert = lambda v: np.asarray(v, dtype=np.float32)
    return convert, np.float32, [t.astype(np.float32) for t in leaf_tables_f64]


def repair_monotone(v: np.ndarray) -> np.ndarray:
    """Minimally bump ties/inversions in the upper half so |v| is strictly
    increasing in magnitude label, then re-antisymmetrize.

    Needed for late DE iterations where the converged pmf's tiny masses
    underflow and the nudged LLRs of dead labels collapse; the exhaustive
    node validation still decides whether the repaired tables reproduce the
    LUTs exactly."""
    v = np.asarray(v, dtype=np.float64).copy()
    K = len(v)
    nz = K // 2
    up = v[nz:].copy()
    prev = max(up[0], 1e-9)
    up[0] = prev
    for i in range(1, len(up)):
        lo = prev * (1 + 1e-6) + 1e-9
        if up[i] <= lo:
            up[i] = lo
        prev = up[i]
    v[nz:] = up
    v[:nz] = -up[::-1]
    return v


def _check_minsum_table(v: np.ndarray):
    """Value table must be antisymmetric with |v| strictly increasing in
    magnitude label and sign matching the label half, so min-sum on values
    is bit-identical to min-sum on labels."""
    K = len(v)
    nz = K // 2
    if not np.all(v[nz:] > 0) or not np.all(v[:nz] < 0):
        raise ArithBuildError("value table sign does not match label half")
    if not np.all(np.diff(v[nz:]) > 0):
        raise ArithBuildError("|value| not strictly monotone in magnitude")
    if not np.allclose(v, -v[::-1], rtol=0, atol=0):
        raise ArithBuildError("value table not antisymmetric")


def _leaf_tables(codec, dtype, reach=None):
    """(convert, work_dtype, leaf_msg list, leaf_cha) in the work dtype.

    With `reach` (per-iteration reachable label masks), dead-label values
    are clamped to tight monotone fillers before scaling — they never occur
    at runtime and would otherwise inflate the int16 range."""
    T = codec.max_iters
    leaf_cha_f64 = nudged_llr(codec.pmf_cha_design)
    # leaf value tables per iteration (messages entering iteration ii);
    # repaired to strict magnitude monotonicity (exactness still verified
    # per node against the integer LUTs)
    leaf_msg_f64 = []
    for ii in range(T):
        v = nudged_llr(codec.pmf_chk2var_trace[ii])
        if reach is not None:
            v = clamp_dead(v, reach[ii])
        leaf_msg_f64.append(repair_monotone(v))
    convert, work_dtype, converted = _dtype_ctx(
        dtype, leaf_msg_f64 + [leaf_cha_f64]
    )
    return convert, work_dtype, converted[:-1], converted[-1]


def build_arith_spec(codec: LUTCodec, dtype=np.float32) -> ArithSpec:
    """Replay the design per iteration and compile the arithmetic decoder
    spec.  Raises ArithBuildError when the codec cannot be represented
    exactly (caller falls back to the table decoder)."""
    if not codec.min_lut:
        raise ArithBuildError("arith decoder covers min-LUT codecs only")
    if codec.pmf_cha_design is None or not codec.pmf_chk2var_trace:
        raise ArithBuildError("codec lacks design pmf snapshots")
    T = codec.max_iters
    if len(codec.pmf_chk2var_trace) != T:
        raise ArithBuildError("pmf trace length mismatch")
    if len(set(int(x) for x in codec.Nq_Msg)) != 1:
        raise ArithBuildError("arith decoder needs uniform Nq_Msg")

    reach = compute_reachable(codec)
    convert, work_dtype, leaf_msg, leaf_cha = _leaf_tables(codec, dtype, reach)
    for v in leaf_msg:
        _check_minsum_table(v)

    degrees = [int(d) for d in codec.var_tree_degrees]
    var_specs = _build_var_specs(
        codec, degrees, leaf_msg, leaf_cha, T - 1, convert, work_dtype, reach
    )

    dec_specs = []
    # decision output convention: value < 0 <=> label < nz <=> bit 1,
    # so label 0 (bit 1) emits -1 and label 1 (bit 0) emits +1
    bit_out = np.array([-1, 1], dtype=work_dtype)
    for di, d in enumerate(degrees):
        tree = codec.var_tree(T - 1, d).copy()  # DECTREE, d+1 leaves
        tree.set_leaves(codec.pmf_chk2var_trace[T - 1], codec.pmf_cha_design)
        tree.update(reuse=True)
        dec_specs.append(
            _build_tree_spec(tree, leaf_msg[T - 1], leaf_cha, bit_out,
                             convert, work_dtype, msg_mask=reach[T - 1])
        )

    # initial messages: labels quantized under qb_Msg -> values of iteration 0
    return ArithSpec(
        var_trees=var_specs,
        dec_trees=dec_specs,
        leaf_msg0=leaf_msg[0],
        leaf_cha=leaf_cha,
        degrees=degrees,
        dtype=work_dtype,
    )


def _build_var_row(codec, degrees, leaf_msg, leaf_cha, ii, convert,
                   work_dtype, msg_mask=None):
    row = []
    for d in degrees:
        tree = codec.var_tree(ii, d).copy()
        tree.set_leaves(codec.pmf_chk2var_trace[ii], codec.pmf_cha_design)
        tree.update(reuse=True)  # recompute node pmfs under the fixed LUTs
        row.append(_build_tree_spec(tree, leaf_msg[ii], leaf_cha,
                                    leaf_msg[ii + 1], convert, work_dtype,
                                    msg_mask=msg_mask))
    return row


def _build_var_specs(codec, degrees, leaf_msg, leaf_cha, num_iters,
                     convert, work_dtype, reach=None):
    var_specs = []
    for ii in range(num_iters):
        row = _build_var_row(codec, degrees, leaf_msg, leaf_cha, ii,
                             convert, work_dtype,
                             None if reach is None else reach[ii])
        # all iterations must share op structure for the scan path
        if var_specs:
            for a, b in zip(var_specs[0], row):
                if a.structure_key() != b.structure_key():
                    raise ArithBuildError("tree structure varies across iterations")
        var_specs.append(row)
    return var_specs


def build_arith_prefix_spec(codec: LUTCodec, max_prefix: int | None = None,
                            dtype=np.float32) -> ArithSpec:
    """Largest valid arithmetic prefix of the decoder.

    Builds VN iterations 0, 1, ... until one fails validation (late DE
    iterations can be degenerate — converged pmfs yield LUTs that no sum
    representation reproduces).  The returned spec has dec_trees=None: it
    supports unanimity-exit decoding only; frames that do not converge
    within spec.num_iters iterations must be re-decoded by a full decoder
    (bit-identical, since decoding is deterministic from the inputs).
    Raises if not even one iteration is representable.
    """
    if not codec.min_lut:
        raise ArithBuildError("arith decoder covers min-LUT codecs only")
    if codec.pmf_cha_design is None or not codec.pmf_chk2var_trace:
        raise ArithBuildError("codec lacks design pmf snapshots")
    T = codec.max_iters
    if len(codec.pmf_chk2var_trace) != T:
        raise ArithBuildError("pmf trace length mismatch")
    if len(set(int(x) for x in codec.Nq_Msg)) != 1:
        raise ArithBuildError("arith decoder needs uniform Nq_Msg")

    reach = compute_reachable(codec)
    convert, work_dtype, leaf_msg, leaf_cha = _leaf_tables(codec, dtype, reach)
    degrees = [int(d) for d in codec.var_tree_degrees]

    limit = T - 1 if max_prefix is None else min(max_prefix, T - 1)
    var_specs = []
    for s in range(limit):
        try:
            _check_minsum_table(leaf_msg[s])  # CN at iteration s needs this
            row = _build_var_row(codec, degrees, leaf_msg, leaf_cha, s,
                                 convert, work_dtype, reach[s])
        except ArithBuildError:
            break
        if var_specs and any(
            a.structure_key() != b.structure_key()
            for a, b in zip(var_specs[0], row)
        ):
            break
        var_specs.append(row)
    if not var_specs:
        raise ArithBuildError("no valid arithmetic prefix")
    return ArithSpec(
        var_trees=var_specs,
        dec_trees=None,
        leaf_msg0=leaf_msg[0],
        leaf_cha=leaf_cha,
        degrees=degrees,
        dtype=work_dtype,
    )
