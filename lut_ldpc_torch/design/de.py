"""Discrete density evolution for LUT decoders: the offline design engine.

Evolves symmetric message pmfs (channel / var-to-chk / chk-to-var) through
LUT trees, designing the MI-optimal LUTs along the way, and searches noise
thresholds by bisection.  Host-side float64 numpy: the pmfs are tiny and the
quantizer DP is sequential, so this intentionally does not run on the TPU --
its *outputs* (integer LUT tables + quantizer boundaries) feed the TPU
decoder.

Semantics mirror reference src/LDPC_DE.cpp (LDPC_DE_LUT, the three
irregular design strategies, bisec_search, get_quant_bound,
get_lam2stable_lut); fp accumulation orders follow the reference so designed
LUTs are bit-identical.
"""

from __future__ import annotations

import numpy as np

from ..core.trees import CHKTREE, LUTTree, TreeNode
from ..ops.pmf import (
    chk_update_minsum,
    get_gaussian_pmf,
    rate_to_shannon_thr,
    seq_sum,
)
from ..ops.quant import quant_mi_sym

ARI, GEO = 0, 1
INDIVIDUAL, JOINT_LEVEL, JOINT_ROOT = "individual", "joint_level", "joint_root"


class DELut:
    """Density evolution engine for LUT message-passing decoders.

    Parameters mirror LDPC_DE_LUT (reference src/LDPC_DE.hpp:127-140).
    chk_tree_templates empty => min-LUT mode (CN update = integer min-sum in
    the pmf domain; no CN LUTs designed).
    """

    def __init__(
        self,
        ens,
        Nq_Cha: int,
        Nq_Msg_vec: np.ndarray,
        maxiter_de: int,
        var_tree_templates: list,
        chk_tree_templates: list | None = None,
        reuse_vec: np.ndarray | None = None,
        thr_prec: float = 1e-6,
        Pe_max: float = 1e-9,
        mean_mode: int = ARI,
        maxiter_bisec: int = 30,
        LLR_max: float = 25.0,
        Nq_fine: int = 5000,
        irregular_design_strategy: str = JOINT_ROOT,
    ):
        self.ens = ens
        self.Nq_Cha = int(Nq_Cha)
        self.Nq_Msg_vec = np.asarray(Nq_Msg_vec, dtype=np.int64)
        self.maxiter_de = int(maxiter_de)
        self.var_tree_templates = var_tree_templates
        self.chk_tree_templates = chk_tree_templates or []
        self.min_lut = not self.chk_tree_templates
        self.reuse_vec = (
            np.zeros(maxiter_de, dtype=bool)
            if reuse_vec is None or len(reuse_vec) == 0
            else np.asarray(reuse_vec, dtype=bool)
        )
        self.thr_prec = thr_prec
        self.Pe_max = Pe_max
        self.mean_mode = mean_mode
        self.maxiter_bisec = maxiter_bisec
        self.max_ni_de_iters = 1
        self.LLR_max = LLR_max
        self.Nq_fine = int(Nq_fine)
        if irregular_design_strategy not in (INDIVIDUAL, JOINT_LEVEL, JOINT_ROOT):
            raise ValueError(f"unknown irregular design strategy {irregular_design_strategy}")
        self.strategy = irregular_design_strategy
        self.thr_max = rate_to_shannon_thr(ens.rate())
        self.thr_min = self.thr_max * 1e-4
        # evolving state
        self.pmf_cha: np.ndarray | None = None
        self.pmf_var2chk: np.ndarray | None = None
        self.pmf_chk2var: np.ndarray | None = None

    # ------------------------------------------------------------------
    def set_exit_conditions(self, maxiter_de=None, maxiter_bisec=None, max_ni_de_iters=None,
                            Pe_max=None, thr_prec=None):
        if maxiter_de is not None:
            self.maxiter_de = int(maxiter_de)
        if maxiter_bisec is not None:
            self.maxiter_bisec = int(maxiter_bisec)
        if max_ni_de_iters is not None:
            self.max_ni_de_iters = int(max_ni_de_iters)
        if Pe_max is not None:
            self.Pe_max = Pe_max
        if thr_prec is not None:
            self.thr_prec = thr_prec

    def set_bisec_window(self, tmin: float, tmax: float):
        self.thr_min = tmin
        self.thr_max = tmax

    def set_channel_pmf(self, sig: float) -> None:
        """Fine-grid Gaussian LLR pmf, MI-quantized to Nq_Cha / Nq_Msg[0]
        (LDPC_DE.cpp:400-412)."""
        delta = 2 * self.LLR_max / self.Nq_fine
        pmf_fine = get_gaussian_pmf(2 / sig**2, 2 / sig, self.Nq_fine, delta)
        _, self.pmf_cha, _ = quant_mi_sym(pmf_fine, self.Nq_Cha, is_sorted=True)
        _, self.pmf_var2chk, _ = quant_mi_sym(pmf_fine, int(self.Nq_Msg_vec[0]), is_sorted=True)

    # ------------------------------------------------------------------
    def evolve(
        self,
        thr: float,
        var_trace: bool = False,
        chk_trace: bool = False,
        save_luts: bool = False,
    ):
        """Run DE at noise stdev thr (LDPC_DE.cpp:198-326).

        Returns (exit_code, trace_P, trace_p, var_trees, chk_trees):
        exit_code >= 0 iff the error probability converged below Pe_max
        (or = max_iter when save_luts).  With save_luts, var_trees/chk_trees
        hold the designed trees [stored iteration][degree].
        """
        if self.reuse_vec[0]:
            raise ValueError("reuse not possible for initial iteration")
        if var_trace and chk_trace:
            raise ValueError("choose either variable or check node tracing")

        nq = np.concatenate([self.Nq_Msg_vec, [2]])  # terminal hard-decision res
        self.set_channel_pmf(thr)

        lam, degree_lam = self.ens.lam, self.ens.degree_lam
        rho, degree_rho = self.ens.rho, self.ens.degree_rho
        prev_var: list[LUTTree | None] = [None] * len(degree_lam)
        prev_chk: list[LUTTree | None] = [None] * len(degree_rho)

        P_rows, p_elems = [], []
        var_trees_out, chk_trees_out = [], []
        # per-iteration pmf_chk2var snapshots (consumed by the arithmetic
        # decoder representation; see decoder/arith.py)
        self.pmf_chk2var_trace = []

        Pe_old = 1.0
        ni_iters = 0
        max_iter = self.maxiter_de if save_luts else self.maxiter_de - 1

        for ii in range(max_iter):
            Pe = seq_sum(self.pmf_var2chk[: int(nq[ii]) // 2])
            if Pe < self.Pe_max and not save_luts:
                return ii, _stack(P_rows), np.array(p_elems), var_trees_out, chk_trees_out
            if Pe <= Pe_old:
                Pe_old = Pe
            else:
                ni_iters += 1
            if ni_iters >= self.max_ni_de_iters and not save_luts:
                return -1, _stack(P_rows), np.array(p_elems), var_trees_out, chk_trees_out

            # ---- CN update
            P_row_c, Pe_c = self._chk_update_irr(ii, nq, prev_chk)
            if save_luts:
                self.pmf_chk2var_trace.append(self.pmf_chk2var.copy())
            if chk_trace:
                P_rows.append(P_row_c)
                p_elems.append(Pe_c)

            # ---- VN update
            P_row_v, Pe_v = self._var_update_irr(ii, nq, prev_var)
            if var_trace:
                P_rows.append(P_row_v)
                p_elems.append(Pe_v)

            if save_luts and not self.reuse_vec[ii]:
                var_trees_out.append([t.copy() for t in prev_var])
                if not self.min_lut:
                    chk_trees_out.append([t.copy() for t in prev_chk])

        if save_luts:
            for row in var_trees_out:
                for t in row:
                    t.reset_pmfs()
            for row in chk_trees_out:
                for t in row:
                    t.reset_pmfs()
            return max_iter, _stack(P_rows), np.array(p_elems), var_trees_out, chk_trees_out
        return -1, _stack(P_rows), np.array(p_elems), var_trees_out, chk_trees_out

    # ------------------------------------------------------------------
    def _chk_update_irr(self, ii: int, nq: np.ndarray, prev_chk: list):
        """pmf_var2chk -> pmf_chk2var (LDPC_DE.cpp:414-489)."""
        rho, degree_rho = self.ens.rho, self.ens.degree_rho
        dc_act = len(degree_rho)
        out = np.zeros(int(nq[ii]))
        P_row = np.zeros(dc_act)
        Pe = 0.0

        if self.min_lut:
            for dd in range(dc_act):
                p_tmp = chk_update_minsum(self.pmf_var2chk, int(degree_rho[dd]))
                P_row[dd] = seq_sum(p_tmp[: len(p_tmp) // 2])
                Pe += rho[dd] * P_row[dd]
                out = out + rho[dd] * p_tmp
            self.pmf_chk2var = out
            return P_row, Pe

        if self.reuse_vec[ii]:
            for dd in range(dc_act):
                prev_chk[dd].set_leaves(self.pmf_var2chk, self.pmf_cha)
                p_tmp = prev_chk[dd].update(reuse=True)
                P_row[dd] = seq_sum(p_tmp[: len(p_tmp) // 2])
                Pe += rho[dd] * P_row[dd]
                out = out + rho[dd] * p_tmp
            self.pmf_chk2var = out
            return P_row, Pe

        for dd in range(dc_act):
            tree = self.chk_tree_templates[ii][dd].copy()
            tree.set_leaves(self.pmf_var2chk, self.pmf_cha)
            tree.set_resolution(int(nq[ii]), int(nq[ii]), self.Nq_Cha)
            prev_chk[dd] = tree

        if self.strategy == INDIVIDUAL:
            for dd in range(dc_act):
                p_tmp = prev_chk[dd].update()
                P_row[dd] = seq_sum(p_tmp[: len(p_tmp) // 2])
                Pe += rho[dd] * P_row[dd]
                out = out + rho[dd] * p_tmp
        else:
            if self.strategy == JOINT_LEVEL:
                joint_level_irr_lut_design(rho, prev_chk)
            else:
                joint_root_irr_lut_design(rho, prev_chk)
            for dd in range(dc_act):
                p_tmp = prev_chk[dd].update(reuse=True)
                P_row[dd] = seq_sum(p_tmp[: len(p_tmp) // 2])
                Pe += rho[dd] * P_row[dd]
                out = out + rho[dd] * p_tmp
        self.pmf_chk2var = out
        return P_row, Pe

    def _var_update_irr(self, ii: int, nq: np.ndarray, prev_var: list):
        """pmf_chk2var + pmf_cha -> pmf_var2chk (LDPC_DE.cpp:494-558)."""
        lam, degree_lam = self.ens.lam, self.ens.degree_lam
        dv_act = len(degree_lam)
        out = np.zeros(int(nq[ii + 1]))
        P_row = np.zeros(dv_act)
        Pe = 0.0

        if self.reuse_vec[ii]:
            for dd in range(dv_act):
                prev_var[dd].set_leaves(self.pmf_chk2var, self.pmf_cha)
                p_tmp = prev_var[dd].update(reuse=True)
                P_row[dd] = seq_sum(p_tmp[: len(p_tmp) // 2])
                Pe += lam[dd] * P_row[dd]
                out = out + lam[dd] * p_tmp
            self.pmf_var2chk = out
            return P_row, Pe

        for dd in range(dv_act):
            tree = self.var_tree_templates[ii][dd].copy()
            tree.set_leaves(self.pmf_chk2var, self.pmf_cha)
            tree.set_resolution(int(nq[ii]), int(nq[ii + 1]), self.Nq_Cha)
            prev_var[dd] = tree

        if self.strategy == INDIVIDUAL:
            for dd in range(dv_act):
                p_tmp = prev_var[dd].update()
                P_row[dd] = seq_sum(p_tmp[: len(p_tmp) // 2])
                Pe += lam[dd] * P_row[dd]
                out = out + lam[dd] * p_tmp
        else:
            if self.strategy == JOINT_LEVEL:
                joint_level_irr_lut_design(lam, prev_var)
            else:
                joint_root_irr_lut_design(lam, prev_var)
            for dd in range(dv_act):
                p_tmp = prev_var[dd].update(reuse=True)
                P_row[dd] = seq_sum(p_tmp[: len(p_tmp) // 2])
                Pe += lam[dd] * P_row[dd]
                out = out + lam[dd] * p_tmp
        self.pmf_var2chk = out
        return P_row, Pe

    # ------------------------------------------------------------------
    def bisec_search(self):
        """Noise-threshold bisection (LDPC_DE.cpp:49-96).

        Returns (num_iterations, threshold); threshold 0.0 on failure.
        """
        lo, hi = self.thr_min, self.thr_max
        sig = -1.0
        for ii in range(self.maxiter_bisec):
            sig = (hi + lo) / 2 if self.mean_mode == ARI else float(np.sqrt(hi * lo))
            ach, *_ = self.evolve(sig)
            if (hi - lo) < self.thr_prec and ach >= 0:
                return ii + 1, sig
            if ach >= 0:
                lo = sig
            else:
                hi = sig
        return -1, 0.0

    def get_lut_trees(self, sig: float):
        """Design and return (var_trees, chk_trees) at noise level sig."""
        _, _, _, var_trees, chk_trees = self.evolve(sig, save_luts=True)
        return var_trees, chk_trees

    def get_quant_bound(self, sig: float):
        """Continuous-LLR decision boundaries of the channel quantizers
        (LDPC_DE.cpp:561-601).  Returns (qb_Cha, qb_Msg)."""
        delta = 2 * self.LLR_max / self.Nq_fine
        pmf_fine = get_gaussian_pmf(2 / sig**2, 2 / sig, self.Nq_fine, delta)
        M = self.Nq_fine

        def bounds(K):
            _, _, Q = quant_mi_sym(pmf_fine, K, is_sorted=True)
            Qr = Q[M // 2 :] - K // 2
            qb = np.zeros(K // 2 - 1)
            label = 0
            for mm in range(M // 2):
                if Qr[mm] > label:
                    qb[label] = mm * delta
                    label += 1
                    if label >= K // 2 - 1:
                        break
            return np.concatenate([-qb[::-1], [0.0], qb])

        return bounds(self.Nq_Cha), bounds(int(self.Nq_Msg_vec[0]))

    def get_lam2stable(self, sig: float) -> float:
        return get_lam2stable_lut(
            sig, self.ens.chk_degree_dist_dense(), self.Nq_Cha, int(self.Nq_Msg_vec[0]),
            self.LLR_max, self.Nq_fine
        )

    # ------------------------------------------------------------------
    def evolve_adaptive_reuse(
        self, thr: float, rel_increase_max: float, rel_decrease_min: float, reuse_max: int
    ) -> np.ndarray:
        """Greedy per-iteration reuse acceptance (LDPC_DE.cpp:328-394).

        Tries reuse at each iteration; keeps it if the relative Pe increase
        stays below rel_increase_max (and decrease above rel_decrease_min,
        and a run-length cap).  Returns the accepted reuse prefix.
        """
        reuse_old = self.reuse_vec.copy()
        nq = np.concatenate([self.Nq_Msg_vec, [2]])
        self.set_channel_pmf(thr)
        prev_var: list = [None] * len(self.ens.degree_lam)
        prev_chk: list = [None] * len(self.ens.degree_rho)
        self.reuse_vec = np.zeros(len(self.reuse_vec), dtype=bool)

        Pe_old_conv = 1.0
        ni_iters = 0
        num_reuse = 0
        ii = 0
        for ii in range(self.maxiter_de - 1):
            Pe = seq_sum(self.pmf_var2chk[: int(nq[ii]) // 2])
            if Pe < self.Pe_max:
                break
            if Pe <= Pe_old_conv:
                Pe_old_conv = Pe
            else:
                ni_iters += 1
            if ni_iters >= self.max_ni_de_iters:
                break
            if ii != 0:
                self.reuse_vec[ii] = True
            pmf_saved = self.pmf_var2chk.copy()
            self._chk_update_irr(ii, nq, prev_chk)
            self._var_update_irr(ii, nq, prev_var)
            Pe_new = seq_sum(self.pmf_var2chk[: int(nq[ii]) // 2])
            Pe_base = seq_sum(pmf_saved[: int(nq[ii]) // 2])
            rel_increase = (Pe_new - Pe_base) / Pe_base
            if (
                rel_increase > rel_increase_max
                or -rel_increase < rel_decrease_min
                or num_reuse > reuse_max
            ):
                self.reuse_vec[ii] = False
                self.pmf_var2chk = pmf_saved
                self._chk_update_irr(ii, nq, prev_chk)
                self._var_update_irr(ii, nq, prev_var)
                num_reuse = 0
            else:
                num_reuse += 1

        out = self.reuse_vec[:ii].copy()
        self.reuse_vec = reuse_old
        return out


def _stack(rows):
    return np.array(rows) if rows else np.zeros((0, 0))


# ---------------------------------------------------------------------------
# joint irregular design strategies (LDPC_DE.cpp:1293-1466)
# ---------------------------------------------------------------------------


def joint_level_irr_lut_design(degree_dist: np.ndarray, trees: list[LUTTree]) -> None:
    """Design one shared quantizer per tree level across all degrees."""
    L = len(trees)
    levels = [t.height() for t in trees]
    cur = max(levels) - 1
    while cur >= 0:
        level_nodes: list[list[TreeNode]] = []
        for ll in range(L):
            if levels[ll] > cur:
                nodes = [n for n in trees[ll].level_nodes(cur) if not n.is_leaf()]
                level_nodes.append(nodes)
            else:
                level_nodes.append([])
        level_lut_tree_update(level_nodes, degree_dist, trees[0].type)
        cur -= 1


def joint_root_irr_lut_design(degree_dist: np.ndarray, trees: list[LUTTree]) -> None:
    """Design individually, then redesign all root quantizers jointly."""
    for t in trees:
        t.update()
    root_nodes = [t.level_nodes(0) for t in trees]
    level_lut_tree_update(root_nodes, degree_dist, trees[0].type)


def level_lut_tree_update(
    tree_nodes: list[list[TreeNode]], degree_dist: np.ndarray, tree_type: int
) -> np.ndarray:
    """Concatenate the half-pmfs of all nodes, run one quant_mi_sym, scatter
    the LUT slices back (LDPC_DE.cpp:1379-1466)."""
    L = len(tree_nodes)
    node_weights, pmf_prod, pmf_len = [], [], []
    M_tot = 0
    num_outlabels = -1
    for ll in range(L):
        nodes = tree_nodes[ll]
        w = np.array([n.num_leaves() for n in nodes], dtype=np.float64)
        if len(w):
            w = w / seq_sum(w)
        node_weights.append(w)
        prods = [n.get_input_product_pmf(tree_type) for n in nodes]
        pmf_prod.append(prods)
        pmf_len.append([len(p) for p in prods])
        for n in nodes:
            if num_outlabels == -1:
                num_outlabels = n.K
            elif num_outlabels != n.K:
                raise ValueError("level_lut_tree_update: output resolution mismatch")
        M_tot += sum(len(p) for p in prods)

    overall = np.full(M_tot, -1e9)
    I = 0
    for ll in range(L):
        for jj, prod in enumerate(pmf_prod[ll]):
            M = len(prod)
            w = node_weights[ll][jj] * degree_dist[ll]
            overall[I : I + M // 2] = w * prod[: M // 2]
            overall[M_tot - I - M // 2 : M_tot - I] = (w * prod[M // 2 :])
            I += M // 2
    overall = overall / seq_sum(overall)

    # masked quantizer design over nonzero support
    nz = 0.5 * (overall + overall[::-1]) != 0
    _, p_out, Q_nz = quant_mi_sym(overall[nz], num_outlabels)
    Q_overall = np.concatenate(
        [
            np.full(M_tot // 2, num_outlabels // 2 - 1, dtype=np.int64),
            np.full(M_tot // 2, num_outlabels // 2, dtype=np.int64),
        ]
    )
    Q_overall[nz] = Q_nz

    I = 0
    for ll in range(L):
        for jj, prod in enumerate(pmf_prod[ll]):
            M = len(prod)
            node = tree_nodes[ll][jj]
            Q_half = Q_overall[I : I + M // 2].copy()
            I += M // 2
            node.Q = Q_half
            p = np.zeros(num_outlabels)
            np.add.at(p, Q_half, prod[: M // 2])
            np.add.at(p, num_outlabels - 1 - Q_half[::-1], prod[M // 2 :])
            node.p = p
    return p_out


# ---------------------------------------------------------------------------
# stability functionals (LDPC_DE.cpp:1472-1614)
# ---------------------------------------------------------------------------


def get_lam2stable_lut(
    sig: float, rho_dense: np.ndarray, Nq_Cha: int, Nq_Msg: int,
    LLR_max: float = 25.0, Nq_fine: int = 5000,
) -> float:
    """Max stable degree-2 VN edge mass for the LUT channel: iterate the
    quantized VN product to a fixed point (LDPC_DE.cpp:1575-1614)."""
    from ..ops.pmf import get_var_product_pmf

    delta = 2 * LLR_max / Nq_fine
    pmf_fine = get_gaussian_pmf(2 / sig**2, 2 / sig, Nq_fine, delta)
    rho = np.asarray(rho_dense, dtype=np.float64)[1:]  # drop degree-1
    _, pmf_cha, _ = quant_mi_sym(pmf_fine, Nq_Cha, is_sorted=True)
    _, pmf_con, _ = quant_mi_sym(pmf_cha, Nq_Msg, is_sorted=True)

    e_to_r = 0.0
    e_to_r_old = np.finfo(np.float64).tiny
    for nn in range(100000):
        prod = get_var_product_pmf([pmf_con, pmf_cha])
        nzm = 0.5 * (prod + prod[::-1]) != 0
        _, pmf_con, _ = quant_mi_sym(prod[nzm], Nq_Msg, is_sorted=True)
        Pe = seq_sum(pmf_con[: Nq_Msg // 2])
        with np.errstate(divide="ignore", over="ignore"):
            e_to_r = float(np.power(Pe, -1.0 / nn)) if nn > 0 else np.inf
        if abs(e_to_r_old - e_to_r) < 1e-6:
            break
        e_to_r_old = e_to_r
    rho_dev_1 = float((rho * np.arange(1, len(rho) + 1)).sum())
    return e_to_r / rho_dev_1


def get_lam2stable_cbp(sig: float, rho_dense: np.ndarray) -> float:
    """Continuous-BP stability bound (LDPC_DE.cpp:1489-1494)."""
    rho = np.asarray(rho_dense, dtype=np.float64)[1:]
    rho_dev_1 = float((rho * np.arange(1, len(rho) + 1)).sum())
    return float(np.exp(1.0 / (2 * sig**2))) / rho_dev_1


def get_lam2stable_qbp_iterative(
    sig: float, rho_dense: np.ndarray, Nq_Cha: int,
    LLR_max: float = 25.0, Nbit: int = 13,
) -> float:
    """Iterative quantized-BP stability estimate (LDPC_DE.cpp:1496-1573).

    Re-expands the Nq_Cha-quantized channel pmf onto a fine uniform LLR
    grid (each quantized mass placed at the grid bin containing its LLR),
    then repeatedly convolves in one more channel observation (degree-2 VN
    update) and tracks the per-iteration error-rate root
    e_to_r = Pe^(-1/i) to a Cauchy fixed point.  The reference's trace-file
    side channel (hard-coded output path, :1541) is intentionally dropped;
    everything else matches, including the fold of the negative overflow
    tail into the lowest bin and the +inf residual bin.
    """
    N = 2 ** (Nbit - 1)
    cauchy = 1e-9
    delta = LLR_max / N
    pmf_fine = get_gaussian_pmf(2 / sig**2, 2 / sig, 2 * N + 2, delta)
    rho = np.asarray(rho_dense, dtype=np.float64)[1:]  # drop degree-1
    _, pmf_cha, _ = quant_mi_sym(pmf_fine, Nq_Cha, is_sorted=True)

    # scatter quantized masses to the fine signed grid by their LLR
    pmf_sparse = np.zeros(2 * N + 2)
    ll = 0
    with np.errstate(divide="ignore"):
        for nn in range(2 * N + 1):
            L = np.log(pmf_cha[ll]) - np.log(pmf_cha[Nq_Cha - 1 - ll])
            s = nn - N
            if s * delta < L <= (s + 1) * delta:
                pmf_sparse[nn] = pmf_cha[ll]
                ll += 1
                if ll >= Nq_Cha:
                    break

    Nfft = 2 ** (1 + int(np.ceil(np.log2(2 * N + 1))))
    pmf_in = pmf_sparse
    pmf_out = pmf_sparse
    e_to_r = 0.0
    e_to_r_old = np.finfo(np.float64).tiny
    for ii in range(2, 100000):
        a = pmf_in[: 2 * N + 1]
        b = pmf_out[: 2 * N + 1]
        tmp = np.fft.irfft(np.fft.rfft(a, Nfft) * np.fft.rfft(b, Nfft), Nfft)
        out = tmp[N : 3 * N + 1].copy()
        out[0] += tmp[:N].sum()
        pmf_out = np.concatenate([out, [1.0 - out.sum()]])
        Pe = pmf_out[:N].sum() + 0.5 * pmf_out[N]
        if Pe == 0:
            break
        e_to_r = float(np.exp(-np.log(Pe) / ii))
        if abs(e_to_r_old - e_to_r) < cauchy:
            break
        e_to_r_old = e_to_r
    rho_dev_1 = float((rho * np.arange(1, len(rho) + 1)).sum())
    return e_to_r / rho_dev_1


def get_lam2stable_qbp(
    sig: float, rho_dense: np.ndarray, Nq_Cha: int = 5000,
    LLR_max: float = 25.0, Nq_fine: int = 5000,
) -> float:
    """Quantized-BP stability bound via Bhattacharyya parameter
    (LDPC_DE.cpp:1472-1487)."""
    delta = 2 * LLR_max / Nq_fine
    pmf_fine = get_gaussian_pmf(2 / sig**2, 2 / sig, Nq_fine, delta)
    rho = np.asarray(rho_dense, dtype=np.float64)[1:]
    _, pmf_cha, _ = quant_mi_sym(pmf_fine, Nq_Cha, is_sorted=True)
    e_to_r = 1.0 / float(np.sqrt(pmf_cha * pmf_cha[::-1]).sum())
    rho_dev_1 = float((rho * np.arange(1, len(rho) + 1)).sum())
    return e_to_r / rho_dev_1
