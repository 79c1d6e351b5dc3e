"""Batched LUT density evolution on the card (port of
lut_ldpc_tpu/design/de_lut_tpu.py).

The host engine (de.DELut) is float64 and sequential over DE iterations and
bisection probes, as the reference is, and designs the LUTs that must be
bit-identical.  Threshold searches evaluate evolve() at many independent
noise levels; this module evolves a whole sigma grid at once in float32
torch ops on an explicit device:

- the MI-optimal quantizer DP (ops/quant.quant_mi_sym) as dense batched
  tensor math (BatchedQuantizer): the partial-MI table g[ap, a] from two
  prefix-sum outer differences, the boundary recursion as Nq/2 - 1 masked
  argmax steps (first maximum on ties, like the host), the LLR sort as a
  stable argsort (which keeps the permutation symmetric);
- LUT-tree evaluation as a static schedule of pairwise pmf joins
  (Kronecker products) from the tree templates the host engine uses;
  identical subtrees are evaluated once an update (the common-subexpression
  elimination XLA applies to the JAX program);
- the min-LUT CN update as suffix-sum min-combinations in the +/-
  transform domain, both transforms stacked in one batch;
- the joint_root / joint_level strategies as one wider DP over the
  concatenated weighted node pmfs with per-origin interval sums;
- full-LUT CN trees whose parity/magnitude fold is a gather-sum through a
  static table (no scatter-add: sums are the same run to run);
- per-point exit conditions carried as masks in the loop of
  design/de_loop.py, which stops when every point has decided.

Float32, as the JAX explorer on every platform: a grid locates the
threshold to about 1e-3 in sigma, and duplicate-LLR label merging is
skipped.  threshold() runs coarse-to-fine grid rounds and can hand the
final bracket to a host de.DELut (host=, refine_host=True).

With a mesh (``mesh=``, a lut_ldpc_torch.parallel.DPMesh) evolve_batch and
prerank_reuse wrap-pad the sigma grid or the candidate rows to a multiple
of the slot count, as the JAX explorer does under shard_map, split them
into contiguous shards, evolve each slot's shard on the slot's device (a
CUDA graph captured per shard shape) and concatenate the shards in order,
across processes through a gloo all_gather.  Points are independent, so
the meshed results are equal to the unmeshed batch's.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.trees import CHA, CHKTREE, VARTREE, LUTTree
from ..device import resolve_device
from ..ops.pmf import get_gaussian_pmf, rate_to_shannon_thr, signed_to_unsigned_map
from ..ops.quant import quant_mi_sym
from .de import INDIVIDUAL, JOINT_LEVEL, JOINT_ROOT
from .de_loop import LoopStats, run_loop

__all__ = ["BatchedQuantizer", "DELutGPU"]

_LOG_FLOOR = 1e-37  # f32 llr-sort guard: masses below this are rounding noise
_NEG = -3.0e38
_LOG2 = math.log(2.0)


def _tree_schedule(tree: LUTTree) -> tuple[list, list, list]:
    """Post-order list of pairwise joins; sources are 'msg' / 'cha' / int
    (earlier op index).  The last op is the root.  Also returns each op's
    LEVEL (distance of its node from the root, host level_nodes
    convention) and its node's leaf count: the joint_level strategy
    groups ops by level and weights them by leaves."""
    ops: list[tuple] = []
    levels: list[int] = []
    leaves: list[int] = []

    def rec(node, depth):
        if node.is_leaf():
            return ("cha" if node.type == CHA else "msg"), 1
        subs = [rec(c, depth + 1) for c in node.children]
        if len(subs) == 1:
            # degree-1 VN: root over the channel leaf alone; a 16->16
            # requantization is a relabeling, which DE is invariant to
            return subs[0]
        if len(subs) != 2:
            raise ValueError(
                "DELutGPU supports binary tree shapes only "
                "(auto_bin_balanced / auto_bin_high)"
            )
        (sa, la), (sb, lb) = subs
        ops.append((sa, sb))
        levels.append(depth)
        leaves.append(la + lb)
        return len(ops) - 1, la + lb

    root_src, _ = rec(tree.root, 0)
    if not ops:
        # single-leaf tree: pass-through marker
        ops.append((root_src, None))
        levels.append(0)
        leaves.append(1)
    return ops, levels, leaves


def _subtree_keys(sched) -> list:
    """Structural key of every op: the nested pair of its sources' keys.
    Equal keys are equal subtrees, whose pmfs are equal."""
    keys: list = []
    for a, b in sched:
        ka = a if isinstance(a, str) else keys[a]
        kb = b if b is None or isinstance(b, str) else keys[b]
        keys.append((ka, kb))
    return keys


# On CUDA, torch's reduction and scan kernels split a row's work by the
# shape of the whole tensor, so a row's rounding could change with the batch
# width, and a meshed shard would differ from the unmeshed batch in the last
# bit.  The two helpers below fix the order there: elementwise adds in a
# fixed tree, which round each element the same way at any width.  On the
# CPU torch's own kernels sum each row in order, whatever the width.

def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` (a fixed pairwise tree on CUDA)."""
    if x.device.type != "cuda":
        return x.sum(dim=dim)
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] + x[h:2 * h]
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along dim 1 (a Hillis-Steele scan on CUDA)."""
    if x.device.type != "cuda":
        return x.cumsum(dim=1)
    step = 1
    while step < x.shape[1]:
        x = torch.cat([x[:, :step], x[:, step:] + x[:, :-step]], dim=1)
        step *= 2
    return x


def _xlog2y(x, y):
    return torch.where(x > 0, x * (torch.log(torch.where(y > 0, y, 1.0)) / _LOG2), 0.0)


class BatchedQuantizer:
    """ops/quant.quant_mi_sym on a batch of symmetric pmfs in float32 (no
    duplicate-LLR merging), with the masks of the DP kept per shape."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._masks: dict = {}
        self._aranges: dict = {}

    def _arange(self, n: int) -> torch.Tensor:
        if n not in self._aranges:
            self._aranges[n] = torch.arange(n, device=self.device)
        return self._aranges[n]

    def _dp_masks(self, H: int, K: int):
        """Masks of the DP over (a, ap) tables, the interval's last index a
        first: the upper triangle ap <= a, the first step's columns, and
        each later step's valid (a, ap = 1..H-1) entries and columns."""
        key = (H, K)
        if key not in self._masks:
            Kh = K // 2
            span = (H * 2 - K) // 2
            col = np.arange(H)
            ap = np.arange(1, H)[None, :]
            tri = col[None, :] <= col[:, None]
            first = col <= span
            valid = np.stack([(ap >= zz) & (ap <= col[:, None]) for zz in range(1, Kh)]
                             or [np.zeros((H, H - 1), bool)])
            sel = np.stack([(col >= zz) & (col <= zz + span) for zz in range(1, Kh)]
                           or [np.zeros(H, bool)])
            dev = self.device
            self._masks[key] = tuple(torch.as_tensor(m, device=dev)
                                     for m in (tri, first, valid, sel))
        return self._masks[key]

    def design(self, ps: torch.Tensor, K: int) -> torch.Tensor:
        """MI-optimal boundaries for LLR-sorted symmetric pmfs.

        ps: (S, 2H) ascending-LLR.  Returns astar (S, K/2+1) int64 interval
        boundaries into the upper half, astar[0] = 0, astar[K/2] = H.
        Mirrors ops/quant.quant_mi_sym's DP (common.cpp:276-311) with the
        first-argmax tie-break, in f32 without duplicate-LLR merging.  The
        tables are held as (a, ap), so every argmax runs over the
        contiguous last axis."""
        S, M = ps.shape
        H = M // 2
        Kh = K // 2
        tri, first, valid, sel = self._dp_masks(H, K)
        pu = ps[:, H:]
        plr = ps[:, :H].flip(1)
        zero = ps.new_zeros(S, 1)
        cu0 = torch.cat([zero, _cumsum(pu)], dim=1)
        cl0 = torch.cat([zero, _cumsum(plr)], dim=1)
        # g[a, ap] = partial MI of interval [ap..a] (ap <= a)
        pp = cu0[:, 1:, None] - cu0[:, None, :-1]   # (S, a, ap)
        pm = cl0[:, 1:, None] - cl0[:, None, :-1]
        tot = pp + pm
        safe = torch.where(tot > 0, tot, 1.0)
        g = _xlog2y(pp, 2.0 * pp / safe) + _xlog2y(pm, 2.0 * pm / safe)
        g = torch.where(tri, g, 0.0)

        Scol = torch.where(first, g[:, :, 0], _NEG)
        h_cols = [None]
        for zz in range(1, Kh):
            # cand[a, ap - 1] = S(ap - 1) + g[a, ap]
            cand = torch.where(valid[zz - 1], Scol[:, None, :-1] + g[:, :, 1:], _NEG)
            best_ap = cand.argmax(dim=2) + 1  # first (lowest) maximum wins
            Scol = torch.where(sel[zz - 1], cand.amax(dim=2), _NEG)
            h_cols.append(best_ap)

        astar = [None] * (Kh + 1)
        astar[Kh] = torch.full((S,), H, dtype=torch.int64, device=ps.device)
        for kk in range(Kh - 1, 0, -1):
            astar[kk] = h_cols[kk].gather(1, (astar[kk + 1] - 1)[:, None])[:, 0]
        astar[0] = torch.zeros(S, dtype=torch.int64, device=ps.device)
        return torch.stack(astar, dim=1)

    @staticmethod
    def interval_sums(masses: torch.Tensor, astar: torch.Tensor) -> torch.Tensor:
        """Per-interval sums: masses (S, H), astar (S, Kh+1) -> (S, Kh)."""
        c0 = torch.cat([masses.new_zeros(masses.shape[0], 1), _cumsum(masses)], dim=1)
        return c0.gather(1, astar[:, 1:]) - c0.gather(1, astar[:, :-1])

    def labels(self, astar: torch.Tensor, H: int, K: int) -> torch.Tensor:
        """Sorted-position labels: (S, Kh+1) boundaries -> (S, 2H) labels."""
        Kh = K // 2
        pos = self._arange(H)[None, None, :]
        iv = (pos >= astar[:, 1:Kh, None]).sum(dim=1)  # (S, H)
        return torch.cat([(Kh - 1 - iv).flip(1), Kh + iv], dim=1)

    def sort_llr(self, p: torch.Tensor) -> torch.Tensor:
        """Stable ascending-LLR permutation of symmetric pmfs (S, M)."""
        logp = torch.log(torch.clamp_min(p, _LOG_FLOOR))
        return torch.argsort(logp - logp.flip(1), dim=1, stable=True)

    def quantize_q(self, p: torch.Tensor, K: int, with_q: bool = True):
        """Batched quant_mi_sym: (S, M) -> (p_out (S, K), Q (S, M) or
        None).  Q is the label-domain map (values 0..K-1), symmetric like
        the host's Q_out: what LUT reuse re-applies to later pmfs."""
        idx = self.sort_llr(p)
        ps = p.gather(1, idx)
        astar = self.design(ps, K)
        H = p.shape[1] // 2
        up = self.interval_sums(ps[:, H:], astar)
        lo = self.interval_sums(ps[:, :H].flip(1), astar)
        p_out = torch.cat([lo.flip(1), up], dim=1)
        if not with_q:
            return p_out, None
        return p_out, self.labels(astar, H, K).gather(1, _inverse(idx))

    def apply_q(self, p: torch.Tensor, Q: torch.Tensor, K: int) -> torch.Tensor:
        """Re-apply a stored label map: p_out[k] = sum_m p[m] * [Q[m] = k]."""
        onehot = Q[:, :, None] == self._arange(K)[None, None, :]
        return _tree_sum(torch.where(onehot, p[:, :, None], 0.0), 1)


def _inverse(idx: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of permutations (S, M)."""
    ar = torch.arange(idx.shape[1], device=idx.device).expand_as(idx)
    return torch.empty_like(idx).scatter_(1, idx, ar)


def _normalize(q):
    return q / _tree_sum(q, 1)[:, None]


def _weighted_sum(weights, pmfs):
    out = None
    for w, q in zip(weights, pmfs):
        out = w * q if out is None else out + w * q
    return out


class DELutGPU:
    """Batched-evolve DE engine for LUT decoders (min-LUT or full-LUT CN).

    evolve_batch(sigmas) evaluates a whole noise grid on `device` (default
    the card; "cpu" where asked for); threshold() runs a coarse-to-fine
    grid search with optional f64 host refinement (pass a host de.DELut
    via host=).  mesh: a parallel.DPMesh that evolve_batch and
    prerank_reuse shard their points over (`device` is then None or the
    device of this process's first slot).  Attributes a caller may
    change: sync_every, the iterations between host reads of the done
    flag, and graph, whether a loop's body is replayed as a CUDA graph (on
    CUDA only; default there).
    """

    def __init__(self, ens, Nq_Cha: int = 16, Nq_Msg=16,
                 maxiter_de: int = 200, Pe_max: float = 1e-6,
                 max_ni_de_iters: int = 1, LLR_max: float = 25.0,
                 Nq_fine: int = 5000, tree_mode: str = "auto_bin_balanced",
                 strategy: str = JOINT_ROOT, host=None, min_lut: bool = True,
                 device=None, mesh=None):
        if strategy not in (INDIVIDUAL, JOINT_ROOT, JOINT_LEVEL):
            raise ValueError(
                f"DELutGPU supports individual/joint_root/joint_level "
                f"strategies, not {strategy}"
            )
        self.ens = ens
        self.Nq_Cha = int(Nq_Cha)
        # scalar = uniform per-iteration resolution; a vector (length
        # maxiter_de, host Nq_Msg_vec semantics: entry ii = resolution of
        # the messages PRODUCED by VN iteration ii-1 / consumed by ii)
        # runs the segmented evolve
        if np.isscalar(Nq_Msg):
            self.Nq_Msg_vec = np.full(int(maxiter_de), int(Nq_Msg), np.int64)
        else:
            self.Nq_Msg_vec = np.asarray(Nq_Msg, dtype=np.int64)
            if len(self.Nq_Msg_vec) != int(maxiter_de):
                raise ValueError("Nq_Msg vector must have maxiter_de entries")
        self.uniform_nq = bool(np.all(self.Nq_Msg_vec == self.Nq_Msg_vec[0]))
        self.Nq_Msg = int(self.Nq_Msg_vec[0])
        self.maxiter_de = int(maxiter_de)
        # f32 floor: pmf tails below ~1e-7 are rounding noise
        self.Pe_max = max(float(Pe_max), 1e-6)
        self.max_ni_de_iters = int(max_ni_de_iters)
        self.LLR_max = float(LLR_max)
        self.Nq_fine = int(Nq_fine)
        self.strategy = strategy
        self.min_lut = bool(min_lut)
        self.host = host
        self.thr_min = rate_to_shannon_thr(ens.rate()) * 1e-4
        self.thr_max = rate_to_shannon_thr(ens.rate())
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device("cuda" if device is None else device)
        else:
            self.device = mesh.devices[0]
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's first slot "
                                 f"({self.device})")
        # explorers of this process's other slot devices, made at first use
        self._kw = dict(Nq_Cha=Nq_Cha, Nq_Msg=Nq_Msg, maxiter_de=maxiter_de, Pe_max=Pe_max,
                        max_ni_de_iters=max_ni_de_iters, LLR_max=LLR_max, Nq_fine=Nq_fine,
                        tree_mode=tree_mode, strategy=strategy, min_lut=min_lut)
        self._on = {self.device: self}
        self.sync_every = 8
        self.graph = self.device.type == "cuda"
        self.stats = LoopStats()
        self.quant = BatchedQuantizer(self.device)

        # one schedule per active VN degree (same shape every iteration;
        # the terminal decision tree only affects the hard output, not the
        # threshold); levels/leaves feed the joint_level strategy
        trip = [_tree_schedule(LUTTree.auto(int(d), VARTREE, tree_mode))
                for d in ens.degree_lam]
        self._schedules = [t[0] for t in trip]
        self._sched_levels = [t[1] for t in trip]
        self._sched_leaves = [t[2] for t in trip]
        # full-LUT mode: CN trees over dc-1 message leaves (LDPC_DE.cpp:
        # 414-489 non-min branch); min-LUT uses the closed-form pmf min-sum
        if self.min_lut:
            self._chk_schedules = None
            self._chk_levels = self._chk_leaves = None
        else:
            ctrip = [_tree_schedule(LUTTree.auto(int(d) - 1, CHKTREE, tree_mode))
                     for d in ens.degree_rho]
            self._chk_schedules = [t[0] for t in ctrip]
            self._chk_levels = [t[1] for t in ctrip]
            self._chk_leaves = [t[2] for t in ctrip]
        if any(int(d) == 1 for d in ens.degree_lam) and self.Nq_Cha != self.Nq_Msg:
            raise NotImplementedError(
                "degree-1 VNs with Nq_Cha != Nq_Msg need a real root requant"
            )
        self._lam = [float(x) for x in ens.lam]
        self._rho = [float(x) for x in ens.rho]
        order_c = np.argsort(ens.degree_rho)
        self._dc_sorted = [int(d) for d in ens.degree_rho[order_c]]
        self._rho_sorted = [float(x) for x in ens.rho[order_c]]
        self._folds: dict = {}
        self._origins: dict = {}

    # -- shared per-iteration math ---------------------------------------
    @staticmethod
    def _min_comb(a, b):
        # min of two magnitudes: c[k] = a[k]*P(B>=k) + b[k]*P(A>k)
        b_suf = _cumsum(b.flip(1)).flip(1)
        a_suf = _cumsum(a.flip(1)).flip(1)
        a_strict = torch.cat([a_suf[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        return a * b_suf + b * a_strict

    def _chk_min(self, v2c):
        """Incremental min-LUT CN DE over ascending degrees; the + and -
        transforms run stacked as rows [0, S) and [S, 2S)."""
        n = v2c.shape[1] // 2
        hi, lo = v2c[:, n:], v2c[:, :n].flip(1)
        a = torch.cat([hi + lo, hi - lo], dim=0)
        c = a
        terms = []
        dc_tmp = 2
        for dc in self._dc_sorted:
            for _ in range(dc - dc_tmp):
                c = self._min_comb(a, c)
            dc_tmp = max(dc_tmp, dc)
            c_p, c_m = c.chunk(2, dim=0)
            terms.append(torch.cat([(0.5 * (c_p - c_m)).flip(1), 0.5 * (c_p + c_m)], dim=1))
        return _weighted_sum(self._rho_sorted, terms)

    @staticmethod
    def _join(pa, pb):
        # mixed-radix product, input 0 least significant (common.cpp:30)
        return (pb[:, :, None] * pa[:, None, :]).reshape(pa.shape[0], -1)

    def _chk_join(self, pa, pb):
        """CN product pmf folded to parity/magnitude labels
        (get_chk_product_pmf, common.cpp:41-70): bin j sums the product
        entries that signed_to_unsigned_map sends to j, in index order."""
        Ka, Kb = pa.shape[1], pb.shape[1]
        if (Ka, Kb) not in self._folds:
            fold = signed_to_unsigned_map(np.array([Ka, Kb]))
            n_out = 2 * (Ka // 2) * (Kb // 2)
            counts = np.bincount(fold, minlength=n_out)
            table = np.full((n_out, int(counts.max())), Ka * Kb, np.int64)
            for j in range(n_out):
                src = np.nonzero(fold == j)[0]
                table[j, :len(src)] = src
            self._folds[(Ka, Kb)] = torch.as_tensor(table, device=self.device)
        table = self._folds[(Ka, Kb)]
        S = pa.shape[0]
        p0 = (pb[:, :, None] * pa[:, None, :]).reshape(S, -1)
        p1 = (pb.flip(1)[:, :, None] * pa.flip(1)[:, None, :]).reshape(S, -1)
        prod0 = 0.5 * (p0 + p1)
        prod0 = torch.cat([prod0, prod0.new_zeros(S, 1)], dim=1)
        return _tree_sum(prod0[:, table], 2)

    @staticmethod
    def _pe(v2c):
        return _tree_sum(v2c[:, : v2c.shape[1] // 2], 1)

    def _quantize(self, p, K):
        return self.quant.quantize_q(p, K, with_q=False)[0]

    # -- tree evaluation -------------------------------------------------
    def _run_tree(self, sched, leaf, K_in, joinf, memo):
        """Post-order evaluation: each internal node's product pmf is
        MI-quantized to the INCOMING resolution before feeding its parent
        (host: set_resolution(nq[ii], nq[ii+1], _), de.py:265).  Returns
        the ROOT's product pmf (its quantization is the strategy's job).
        memo holds the quantized pmf of every subtree evaluated in this
        update, by structural key."""
        keys = _subtree_keys(sched)
        outs = []
        for i, (a, b) in enumerate(sched):
            if b is None:  # degree-1 VN: root over the channel leaf
                return leaf(a)
            pa = leaf(a) if isinstance(a, str) else outs[a]
            pb = leaf(b) if isinstance(b, str) else outs[b]
            if i == len(sched) - 1:
                return joinf(pa, pb)
            if keys[i] not in memo:
                memo[keys[i]] = _normalize(self._quantize(joinf(pa, pb), K_in))
            outs.append(memo[keys[i]])
        raise AssertionError("empty schedule")

    def _origin(self, halves):
        """Node index of every entry of the concatenated half-pmfs."""
        key = tuple(halves)
        if key not in self._origins:
            org = [np.full(M2, ll, np.int64) for ll, M2 in enumerate(halves)]
            origin = np.concatenate(org + org[::-1])
            self._origins[key] = torch.as_tensor(origin, device=self.device)
        return self._origins[key]

    def _joint_nodes(self, prods, node_w, K, with_q=False):
        """de.level_lut_tree_update as batched tensor math: concatenate the
        weighted half-pmfs of all nodes symmetrically, one DP at resolution
        K, per-origin interval sums rebuild each node's output pmf
        (normalized).  Returns one (S, K) pmf per node and, with_q, each
        node's label map over its own product alphabet."""
        qz = self.quant
        halves = [p.shape[1] // 2 for p in prods]
        low_w = [w * p[:, :M2] for w, p, M2 in zip(node_w, prods, halves)]
        up_w = [w * p[:, M2:] for w, p, M2 in zip(node_w, prods, halves)]
        low_u = [p[:, :M2] for p, M2 in zip(prods, halves)]
        up_u = [p[:, M2:] for p, M2 in zip(prods, halves)]
        overall = _normalize(torch.cat(low_w + up_w[::-1], dim=1))
        unweighted = torch.cat(low_u + up_u[::-1], dim=1)
        S, Mtot = overall.shape
        idx = qz.sort_llr(overall)
        ow = overall.gather(1, idx)
        ou = unweighted.gather(1, idx)
        oo = self._origin(halves)[idx]
        astar = qz.design(ow, K)
        Ht = Mtot // 2
        L = len(prods)
        nodes = torch.arange(L, device=overall.device)[:, None, None]
        m_up = torch.where(oo[None, :, Ht:] == nodes, ou[None, :, Ht:], 0.0)
        m_lo = torch.where(oo[None, :, :Ht].flip(2) == nodes, ou[None, :, :Ht].flip(2), 0.0)
        astar_l = astar.repeat(L, 1)
        up = qz.interval_sums(m_up.reshape(L * S, Ht), astar_l)
        lo = qz.interval_sums(m_lo.reshape(L * S, Ht), astar_l)
        q = _normalize(torch.cat([lo.flip(1), up], dim=1)).reshape(L, S, K)
        outs = list(q.unbind(0))
        if not with_q:
            return outs
        Q_all = qz.labels(astar, Ht, K).gather(1, _inverse(idx))
        Q_nodes, I = [], 0
        for M2 in halves:
            Q_nodes.append(torch.cat([Q_all[:, I:I + M2],
                                      Q_all[:, Mtot - I - M2:Mtot - I]], dim=1))
            I += M2
        return outs, Q_nodes

    def _mix_individual(self, root_prods, weights, K_out):
        qs = []
        for prod in root_prods:
            if prod.shape[1] != K_out:
                prod = self._quantize(prod, K_out)
            qs.append(_normalize(prod))
        return _weighted_sum(weights, qs)

    def _joint_level_update(self, scheds, levels, leaves, weights, joinf,
                            leaf_of, K_in, K_out):
        """One shared quantizer per tree LEVEL across degrees
        (de.joint_level_irr_lut_design): bottom-up over levels, each
        level's node product pmfs run ONE DP with host weighting (per-tree
        leaf fractions x degree mass)."""
        outs = [dict() for _ in scheds]

        def resolve(t, src):
            return leaf_of(src) if isinstance(src, str) else outs[t][src]

        maxlev = max((max(lv) if lv else 0) for lv in levels)
        for lev in range(maxlev, -1, -1):
            group, prods, ws = [], [], []
            for t, (sched, lvs, lfs) in enumerate(zip(scheds, levels, leaves)):
                idxs = [i for i in range(len(sched))
                        if lvs[i] == lev and sched[i][1] is not None]
                tot = float(sum(lfs[i] for i in idxs)) or 1.0
                for i in idxs:
                    a, b = sched[i]
                    prods.append(joinf(resolve(t, a), resolve(t, b)))
                    ws.append(weights[t] * lfs[i] / tot)
                    group.append((t, i))
            if not group:
                continue
            qs = self._joint_nodes(prods, ws, K_out if lev == 0 else K_in)
            for (t, i), q in zip(group, qs):
                outs[t][i] = q
        finals = []
        for t, sched in enumerate(scheds):
            ri = len(sched) - 1
            if sched[ri][1] is None:  # pass-through (degree-1)
                q = resolve(t, sched[ri][0])
                if q.shape[1] != K_out:
                    q = _normalize(self._quantize(q, K_out))
            else:
                q = outs[t][ri]
            finals.append(q)
        return _weighted_sum(weights, finals)

    def _var_update(self, c2v, cha, K_in, K_out):
        scheds = self._schedules
        if self.strategy == JOINT_LEVEL and len(scheds) > 1:
            return self._joint_level_update(
                scheds, self._sched_levels, self._sched_leaves, self._lam,
                self._join, lambda s: c2v if s == "msg" else cha, K_in, K_out)
        leaf = lambda s: c2v if s == "msg" else cha
        memo: dict = {}
        root_prods = [self._run_tree(s, leaf, K_in, self._join, memo) for s in scheds]
        if self.strategy == INDIVIDUAL or len(scheds) == 1:
            return self._mix_individual(root_prods, self._lam, K_out)
        return self._mix_individual(
            self._joint_nodes(root_prods, self._lam, K_out), self._lam, K_out)

    def _chk_full(self, v2c, K_in):
        # full-LUT CN: host CN resolution per iteration is
        # set_resolution(nq[ii], nq[ii], _) (de.py:222), in and out K_in
        scheds = self._chk_schedules
        if self.strategy == JOINT_LEVEL and len(scheds) > 1:
            return self._joint_level_update(
                scheds, self._chk_levels, self._chk_leaves, self._rho,
                self._chk_join, lambda s: v2c, K_in, K_in)
        memo: dict = {}
        root_prods = [self._run_tree(s, lambda s_: v2c, K_in, self._chk_join, memo)
                      for s in scheds]
        if self.strategy == INDIVIDUAL or len(scheds) == 1:
            return self._mix_individual(root_prods, self._rho, K_in)
        return self._mix_individual(
            self._joint_nodes(root_prods, self._rho, K_in), self._rho, K_in)

    def _step(self, v2c, cha, K_in, K_out):
        c2v = self._chk_min(v2c) if self.min_lut else self._chk_full(v2c, K_in)
        return self._var_update(c2v, cha, K_in, K_out)

    # -- evolve ------------------------------------------------------------
    def evolve(self, v2c0: torch.Tensor, cha: torch.Tensor):
        """(achieved, Pe, it) per point for float32 message and channel
        pmfs on the device: the JAX program's outputs (`it` is the loop's
        iteration count on the uniform path, each point's latched exit
        iteration on the segmented one)."""
        if self.uniform_nq:
            return self._evolve_uniform(v2c0, cha)
        return self._evolve_segmented(v2c0, cha)

    def _evolve_uniform(self, v2c0, cha):
        K = self.Nq_Msg
        Pe_max, max_ni, maxiter = self.Pe_max, self.max_ni_de_iters, self.maxiter_de
        S, dev = v2c0.shape[0], v2c0.device

        def body(state):
            it, v2c, done, Pe_old, ni, it_l = state
            v2c_new = self._step(v2c, cha, K, K)
            Pe = self._pe(v2c_new)
            conv = Pe < Pe_max
            # the host counts only STRICTLY worse iterations (de.py: Pe <=
            # Pe_old is improving); de_bp's host differs
            worse = Pe > Pe_old
            ni = torch.where(~done & worse, ni + 1, ni)
            done_new = done | conv | (ni >= max_ni)
            it_l = torch.where(done_new & ~done, it + 1, it_l)
            v2c = torch.where(done[:, None], v2c, v2c_new)
            Pe_old = torch.where(done | worse, Pe_old, Pe)
            return it + 1, v2c, done_new, Pe_old, ni, it_l

        state = (torch.zeros((), dtype=torch.int32, device=dev), v2c0,
                 torch.zeros(S, dtype=torch.bool, device=dev),
                 torch.ones(S, dtype=torch.float32, device=dev),
                 torch.zeros(S, dtype=torch.int32, device=dev),
                 torch.full((S,), maxiter, dtype=torch.int32, device=dev))
        _, v2c, _, _, _, it_l = run_loop(body, state, maxiter, lambda st: st[2],
                                         self.sync_every, self.graph, self.stats)
        Pe = self._pe(v2c)
        return Pe < Pe_max, Pe, it_l.max().expand(S)

    def _evolve_segmented(self, v2c0, cha):
        """Non-uniform per-iteration resolutions: nqv[ii] is the width of
        v2c ENTERING iteration ii; runs of equal consecutive widths execute
        as one loop, the boundary iteration (output width nqv[ii+1] !=
        nqv[ii]) as a single step.  Converged / failed points latch Pe and
        their exit iteration instead of freezing the (width-changing) pmf
        carry: decision-identical."""
        nqv = self.Nq_Msg_vec
        Pe_max, max_ni, maxiter = self.Pe_max, self.max_ni_de_iters, self.maxiter_de
        S, dev = v2c0.shape[0], v2c0.device
        runs = []
        s0 = 0
        for ii in range(1, maxiter + 1):
            if ii == maxiter or nqv[ii] != nqv[s0]:
                runs.append((s0, ii, int(nqv[s0])))
                s0 = ii

        def account(state, v2c_new):
            it, _, done, conv_l, Pe_l, Pe_old, ni, it_l = state
            Pe = self._pe(v2c_new)
            conv = Pe < Pe_max
            worse = Pe > Pe_old
            ni = torch.where(~done & worse, ni + 1, ni)
            fail = ni >= max_ni
            newly = ~done & (conv | fail)
            conv_l = conv_l | (newly & conv)
            Pe_l = torch.where(newly, Pe, Pe_l)
            it_l = torch.where(newly, it + 1, it_l)
            done = done | conv | fail
            Pe_old = torch.where(done | worse, Pe_old, Pe)
            # no freeze: converged points latch Pe / it above and their
            # free-running pmf is never read again
            return it + 1, v2c_new, done, conv_l, Pe_l, Pe_old, ni, it_l

        state = (None, v2c0, torch.zeros(S, dtype=torch.bool, device=dev),
                 torch.zeros(S, dtype=torch.bool, device=dev),
                 torch.full((S,), math.inf, dtype=torch.float32, device=dev),
                 torch.ones(S, dtype=torch.float32, device=dev),
                 torch.zeros(S, dtype=torch.int32, device=dev),
                 torch.full((S,), maxiter, dtype=torch.int32, device=dev))
        for lo_it, hi_it, K_in in runs:
            K_next = int(nqv[hi_it]) if hi_it < maxiter else K_in
            n_inner = (hi_it - lo_it) if K_next == K_in else (hi_it - lo_it - 1)
            it0 = torch.full((), lo_it, dtype=torch.int32, device=dev)
            state = (it0,) + state[1:]
            if n_inner > 0:
                def body(st, K_in=K_in):
                    return account(st, self._step(st[1], cha, K_in, K_in))

                state = run_loop(body, state, n_inner, lambda st: st[2],
                                 self.sync_every, self.graph, self.stats)
            if K_next != K_in:
                # boundary iteration: the output width changes
                it_b = torch.full((), hi_it - 1, dtype=torch.int32, device=dev)
                state = account((it_b,) + state[1:],
                                self._step(state[1], cha, K_in, K_next))
                self.stats.loops.append(1)
        _, v2c, done, conv_l, Pe_l, _, _, it_l = state
        Pe_fin = torch.where(done, Pe_l, self._pe(v2c))
        ach = torch.where(done, conv_l, Pe_fin < Pe_max)
        return ach, Pe_fin, it_l

    # -- reuse-aware evolve (design-space tool for reuse_vec_opt) ---------
    def _evolve_reuse(self, v2c0, cha, reuse_mat, pmax):
        """A batch of LUT-reuse vectors at one noise level.  Each node's
        label-domain Q map is carried in the loop; a reuse iteration
        re-applies the stored maps instead of designing
        (de.DELut._var_update_irr's reuse branch, LDPC_DE.cpp:494-515).
        Equal subtrees share one map: they design equal maps, as their
        pmfs are equal.  Returns (final Pe, first iteration with Pe <
        pmax or maxiter)."""
        K, Nq_Cha = self.Nq_Msg, self.Nq_Cha
        max_ni, maxiter = self.max_ni_de_iters, self.maxiter_de
        scheds, lam, qz = self._schedules, self._lam, self.quant
        joint = not (self.strategy == INDIVIDUAL or len(scheds) == 1)
        C, dev = reuse_mat.shape[0], reuse_mat.device

        # static slot registry: every distinct interior subtree and every
        # root carries a label map over its PRODUCT alphabet (K per msg /
        # interior operand, Nq_Cha per channel leaf)
        def size(src):
            return Nq_Cha if src == "cha" else K

        slot_of, slot_sizes = {}, []
        for t, sched in enumerate(scheds):
            keys = _subtree_keys(sched)
            for i, (a, b) in enumerate(sched):
                key = ("root", t) if i == len(sched) - 1 else keys[i]
                if key not in slot_of:
                    slot_of[key] = len(slot_sizes)
                    slot_sizes.append(size(a) if b is None else size(a) * size(b))
        n_fix = 6

        def body(state):
            it, v2c, done, Pe_old, ni, it_hit = state[:n_fix]
            Qs = list(state[n_fix:])
            reuse_f = reuse_mat.index_select(1, it.long().reshape(1))  # (C, 1)
            c2v = self._chk_min(v2c)
            leaf = lambda s: c2v if s == "msg" else cha
            memo: dict = {}
            root_prods, root_slots = [], []
            for t, sched in enumerate(scheds):
                keys = _subtree_keys(sched)
                outs = []
                for i, (a, b) in enumerate(sched):
                    if i == len(sched) - 1:  # the root, or a degree-1 pass-through
                        root_prods.append(leaf(a) if b is None else self._join(
                            leaf(a) if isinstance(a, str) else outs[a],
                            leaf(b) if isinstance(b, str) else outs[b]))
                        root_slots.append(slot_of[("root", t)])
                        break
                    if keys[i] not in memo:
                        prod = self._join(leaf(a) if isinstance(a, str) else outs[a],
                                          leaf(b) if isinstance(b, str) else outs[b])
                        slot = slot_of[keys[i]]
                        q_new, Q_new = qz.quantize_q(prod, K)
                        q = torch.where(reuse_f, qz.apply_q(prod, Qs[slot], K), q_new)
                        Qs[slot] = torch.where(reuse_f, Qs[slot], Q_new)
                        memo[keys[i]] = _normalize(q)
                    outs.append(memo[keys[i]])
            if joint:
                q_des, Q_des = self._joint_nodes(root_prods, lam, K, with_q=True)
            else:
                q_des, Q_des = [], []
                for prod in root_prods:
                    if prod.shape[1] > K:
                        qd, Qd = qz.quantize_q(prod, K)
                    else:  # degree-1 (Nq_Cha == Nq_Msg): sorted identity
                        qd = prod
                        Qd = torch.arange(K, device=dev).expand(C, K)
                    q_des.append(qd)
                    Q_des.append(Qd)
            terms = []
            for prod, slot, qd, Qd in zip(root_prods, root_slots, q_des, Q_des):
                q = torch.where(reuse_f, qz.apply_q(prod, Qs[slot], K), qd)
                Qs[slot] = torch.where(reuse_f, Qs[slot], Qd)
                terms.append(_normalize(q))
            v2c_new = _weighted_sum(lam, terms)
            Pe = self._pe(v2c_new)
            conv = Pe < pmax
            # strictly-worse only, matching the host engine (de.py)
            worse = Pe > Pe_old
            ni = torch.where(~done & worse, ni + 1, ni)
            it_hit = torch.where(conv & ~done & (it_hit == maxiter), it, it_hit)
            done_new = done | conv | (ni >= max_ni)
            v2c = torch.where(done[:, None], v2c, v2c_new)
            Pe_old = torch.where(done | worse, Pe_old, Pe)
            return (it + 1, v2c, done_new, Pe_old, ni, it_hit, *Qs)

        state = (torch.zeros((), dtype=torch.int32, device=dev), v2c0,
                 torch.zeros(C, dtype=torch.bool, device=dev),
                 torch.ones(C, dtype=torch.float32, device=dev),
                 torch.zeros(C, dtype=torch.int32, device=dev),
                 torch.full((C,), maxiter, dtype=torch.int32, device=dev),
                 *[torch.zeros((C, sz), dtype=torch.int64, device=dev) for sz in slot_sizes])
        state = run_loop(body, state, maxiter, lambda st: st[2],
                         self.sync_every, self.graph, self.stats)
        return self._pe(state[1]), state[5]

    def prerank_reuse(self, sig: float, reuse_mat, pmax: float = 1e-17):
        """Evaluate a batch of reuse vectors at noise level sig in one
        batched loop.  Returns (final Pe, first iteration with Pe < pmax
        or maxiter) per row: f32 exploration for reuse_vec_opt's greedy
        search; the host f64 engine confirms the top candidates."""
        if not self.min_lut:
            raise NotImplementedError("reuse pre-ranking covers min-LUT mode only")
        if not self.uniform_nq:
            raise NotImplementedError(
                "reuse pre-ranking needs a uniform message resolution")
        reuse_mat = np.asarray(reuse_mat, dtype=bool)
        if reuse_mat.ndim != 2 or reuse_mat.shape[1] != self.maxiter_de:
            raise ValueError("reuse_mat must be (num_candidates, maxiter_de)")
        if reuse_mat[:, 0].any():
            raise ValueError("reuse not possible for initial iteration")
        C = reuse_mat.shape[0]
        rows, w = self._pad(reuse_mat)

        def run(tde, i):
            part = rows[i * w:(i + 1) * w]
            p_cha, p_msg = tde._channel_pmfs(float(sig))
            cha = p_cha[None].expand(len(part), -1).contiguous()
            v2c = p_msg[None].expand(len(part), -1).contiguous()
            return tde._evolve_reuse(v2c, cha, torch.as_tensor(part, device=tde.device),
                                     float(pmax))
        return self._over_slots(run, C)

    # -- the mesh ---------------------------------------------------------
    def _pad(self, rows: np.ndarray):
        """Rows wrap-padded to a multiple of the slot count (the JAX
        explorer's np.resize), and the rows of one slot's shard."""
        n = 1 if self.mesh is None else len(self.mesh)
        padded = np.resize(rows, (-(-len(rows) // n) * n, *rows.shape[1:]))
        return padded, len(padded) // n

    def _explorer(self, dev: torch.device) -> "DELutGPU":
        if dev not in self._on:
            sub = DELutGPU(self.ens, **self._kw, host=self.host, device=dev)
            sub.stats = self.stats
            self._on[dev] = sub
        sub = self._on[dev]
        sub.sync_every, sub.graph = self.sync_every, self.graph and dev.type == "cuda"
        return sub

    def _over_slots(self, run, n_out: int) -> tuple:
        """run(explorer, shard index) -> a tuple of (w,) tensors, for this
        process's shards (all of them without a mesh); the outputs
        concatenated in shard order (gathered across processes) and cut to
        the first n_out rows, as numpy arrays."""
        if self.mesh is None:
            return tuple(t.cpu().numpy()[:n_out] for t in run(self, 0))
        outs = [run(self._explorer(self.mesh.slots[i].device), i) for i in self.mesh.local]
        return tuple(self.mesh.gather([o[j].cpu().numpy() for o in outs]).reshape(-1)[:n_out]
                     for j in range(len(outs[0])))

    # ------------------------------------------------------------------
    def _channel_pmfs(self, s: float):
        """Channel and initial message pmfs for one sigma, quantized on the
        host in f64 exactly like de.DELut.set_channel_pmf, as float32
        device tensors."""
        delta = 2 * self.LLR_max / self.Nq_fine
        fine = get_gaussian_pmf(2 / s**2, 2 / s, self.Nq_fine, delta)
        _, p_cha, _ = quant_mi_sym(fine, self.Nq_Cha, is_sorted=True)
        _, p_msg, _ = quant_mi_sym(fine, self.Nq_Msg, is_sorted=True)
        return (torch.as_tensor(np.asarray(p_cha, np.float32), device=self.device),
                torch.as_tensor(np.asarray(p_msg, np.float32), device=self.device))

    def channel_pmfs(self, sigmas) -> tuple[torch.Tensor, torch.Tensor]:
        """(v2c0, cha) float32 batches on the device for a sigma grid (the
        host quantizer runs in native code and releases the GIL, so the
        points are designed in threads)."""
        sig = [float(s) for s in np.asarray(sigmas, np.float64)]
        with ThreadPoolExecutor(max_workers=max(1, min(len(sig), os.cpu_count() or 1))) as pool:
            pairs = list(pool.map(self._channel_pmfs, sig))
        return (torch.stack([p[1] for p in pairs]), torch.stack([p[0] for p in pairs]))

    def evolve_batch(self, sigmas) -> tuple[np.ndarray, np.ndarray]:
        """(converged mask, final Pe) per sigma."""
        sig = np.asarray(sigmas, np.float64)
        grid, w = self._pad(sig)

        def run(tde, i):
            return tde.evolve(*tde.channel_pmfs(grid[i * w:(i + 1) * w]))[:2]
        return self._over_slots(run, len(sig))

    def threshold(self, points: int = 17, rounds: int = 3,
                  refine_host: bool = False) -> float:
        """Coarse-to-fine batched grid search for the noise threshold.

        Each round evaluates `points` sigmas across the bracket and narrows
        it to the last-converged / first-diverged pair.  refine_host
        finishes with the f64 host engine (requires host=)."""
        lo, hi = self.thr_min, self.thr_max
        for _ in range(rounds):
            grid = np.linspace(lo, hi, points)
            ach, _ = self.evolve_batch(grid)
            if not ach.any():
                hi = grid[1]
                continue
            k = int(np.nonzero(ach)[0].max())
            lo = grid[k]
            if k + 1 < points:
                hi = grid[k + 1]
        if refine_host:
            if self.host is None:
                raise ValueError("threshold(refine_host=True) needs host=DELut(...)")
            self.host.set_bisec_window(lo, hi)
            _, thr = self.host.bisec_search()
            return thr if thr > 0 else lo
        return lo
