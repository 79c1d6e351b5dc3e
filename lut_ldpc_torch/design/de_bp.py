"""Quantized density evolution for float belief propagation (the baseline
DE engine next to the LUT engine); a copy of lut_ldpc_tpu/design/de_bp.py.

Classic DE on a uniform LLR grid with explicit zero and +infinity masses:
VN updates are weighted FFT convolutions, CN updates use the table-aided
box-plus quantization of Richardson/Urbanke (appendix B.3).  Mirrors
LDPC_DE_BP (reference src/LDPC_DE.cpp:617-1042) including the
incremental increasing-degree convolution for irregular ensembles and the
exact tq/tq2 table construction; used by de_sim's BP path for threshold
search.

Host-side float64 numpy — the pmfs are a few thousand entries and the
algorithm is inherently sequential over DE iterations.
"""

from __future__ import annotations

import numpy as np

from ..ops.pmf import get_gaussian_pmf, rate_to_shannon_thr
from .de import ARI, GEO

__all__ = ["DEBp"]


class DEBp:
    """Density evolution for (continuous, finite-grid) BP decoding.

    Nb: grid resolution in bits (N = 2^(Nb-1) positive bins);
    Lmax: LLR clip magnitude.
    """

    def __init__(self, ens, Nb: int = 10, Lmax: float = 25.0):
        self.ens = ens
        self.Nb = int(Nb)
        self.Lmax = float(Lmax)
        self.N = 2 ** (self.Nb - 1)
        N = self.N
        self.delta = 2 * self.Lmax / (2 * N + 1)
        self.Nfft = 2 ** (1 + int(np.ceil(np.log2(2 * N + 1))))
        idx = np.arange(-N, N + 1, dtype=np.float64)
        self.var_conv_weight = np.exp(-0.5 * idx * self.delta)
        # exit conditions (LDPC_DE.cpp:641-646)
        self.max_ni_de_iters = 1
        self.maxiter_de = 1000
        self.Pe_max = 1e-9
        self.maxiter_bisec = 50
        self.thr_prec = 1e-4
        self.mean_mode = ARI
        self.thr_max = rate_to_shannon_thr(ens.rate())
        self.thr_min = self.thr_max / 1e3
        self._set_tq_tables()
        self.pmf_LLR = None
        self.pmf_var2chk = None
        self.pmf_chk2var = None

    # -- configuration ------------------------------------------------------
    def set_exit_conditions(self, maxiter_de=None, maxiter_bisec=None,
                            max_ni_de_iters=None, Pe_max=None, thr_prec=None):
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

    # -- +/- transform (LDPC_DE.cpp:740-779) --------------------------------
    def _pmf_plus(self, pmf):
        N = self.N
        v = np.empty(N + 2)
        v[0] = pmf[N]
        v[1 : N + 1] = pmf[N + 1 : 2 * N + 1] + pmf[:N][::-1]
        v[N + 1] = pmf[2 * N + 1]
        return v

    def _pmf_minus(self, pmf):
        N = self.N
        v = np.empty(N + 2)
        v[0] = 0.0
        v[1 : N + 1] = pmf[N + 1 : 2 * N + 1] - pmf[:N][::-1]
        v[N + 1] = pmf[2 * N + 1]
        return v

    def _pmf_orig(self, p, m):
        N = self.N
        v = np.empty(2 * N + 2)
        v[:N] = (0.5 * (p[1 : N + 1] - m[1 : N + 1]))[::-1]
        v[N] = p[0]
        v[N + 1 : 2 * N + 2] = 0.5 * (p[1 : N + 2] + m[1 : N + 2])
        return v

    # -- convolution kernels -------------------------------------------------
    def _var_update_convolve(self, pmf_in, pmf_out):
        """Weighted FFT convolution (LDPC_DE.cpp:899-956, 'symmetric
        optimistic version')."""
        N, w = self.N, self.var_conv_weight
        a = w * pmf_in[: 2 * N + 1]
        b = w * pmf_out[: 2 * N + 1]
        conv = np.fft.irfft(
            np.fft.rfft(a, self.Nfft) * np.fft.rfft(b, self.Nfft), self.Nfft
        )
        out = conv[N : 3 * N + 1] / w
        return np.concatenate([out, [1.0 - out.sum()]])

    def _chk_update_convolve(self, a_p, a_m, b_p, b_m):
        """Table-aided box-plus pmf combination (LDPC_DE.cpp:958-995)."""
        N, K = self.N, self.K

        def suffix(v):
            fin = v[: N + 1]
            s = fin.sum()
            base = np.concatenate([[s], s - np.cumsum(fin[:N])]) + v[N + 1]
            return np.concatenate([base, [0.0]])

        Ap, Am = suffix(a_p), suffix(a_m)
        Bp, Bm = suffix(b_p), suffix(b_m)
        c_p = np.zeros(N + 2)
        c_m = np.zeros(N + 2)
        tq, tq2 = self.tq, self.tq2
        for i in range(N + 1):
            kmax = min(K, i)
            ks = np.arange(kmax + 1)
            tgt = i - ks
            np.add.at(
                c_p, tgt,
                a_p[i] * (Bp[tq[i, ks + 1]] - Bp[tq[i, ks]])
                + b_p[i] * (Ap[tq2[i, ks + 1]] - Ap[tq2[i, ks]]),
            )
            np.add.at(
                c_m, tgt,
                a_m[i] * (Bm[tq[i, ks + 1]] - Bm[tq[i, ks]])
                + b_m[i] * (Am[tq2[i, ks + 1]] - Am[tq2[i, ks]]),
            )
        # infinity mass: the reference combines the + masses for both
        # transforms (LDPC_DE.cpp:991-992); replicated verbatim
        c_p[N + 1] = a_p[N + 1] * b_p[N + 1]
        c_m[N + 1] = a_p[N + 1] * b_p[N + 1]
        return c_p, c_m

    # -- tq tables (LDPC_DE.cpp:999-1042) ------------------------------------
    def _gen_Q_table(self):
        N, delta = self.N, self.delta
        i = np.arange(N + 1)[:, None] * delta
        j = np.arange(N + 1)[None, :] * delta
        Q = np.floor(
            2 * np.arctanh(np.tanh(0.5 * i) * np.tanh(0.5 * j)) / delta + 0.5
        ).astype(np.int64)
        Q = np.concatenate([Q, np.arange(N + 1)[:, None]], axis=1)
        last_row = np.arange(N + 2)[None, :]
        Q = np.concatenate([Q, last_row], axis=0)
        Q[N + 1, N + 1] = N + 1
        return Q

    def _set_tq_tables(self):
        N = self.N
        Q = self._gen_Q_table()
        self.K = int(np.ceil(np.log(2) / self.delta - 0.5))
        K = self.K
        tq = np.empty((N + 1, K + 2), dtype=np.int64)
        tq2 = np.empty((N + 1, K + 2), dtype=np.int64)
        for i in range(N + 1):
            tq[i, 0] = tq2[i, 0] = N + 1
            row = Q[i]
            for k in range(1, K + 2):
                hits = np.nonzero(row >= i - (k - 1))[0]
                q_idx = int(hits[0]) if len(hits) else np.iinfo(np.int64).min
                tq[i, k] = max(i, q_idx)
                tq2[i, k] = max(i + 1, q_idx)
        self.tq, self.tq2 = tq, tq2

    # -- irregular updates (LDPC_DE.cpp:783-876) -----------------------------
    def _chk_update_irr(self, trace=False):
        N = self.N
        out = np.zeros(2 * N + 2)
        p_in_p = self._pmf_plus(self.pmf_var2chk)
        p_in_m = self._pmf_minus(self.pmf_var2chk)
        order = np.argsort(self.ens.degree_rho)
        dc_vec = self.ens.degree_rho[order]
        rho = self.ens.rho[order]
        out_p, out_m = p_in_p.copy(), p_in_m.copy()
        dc_tmp = 2
        P_row = np.zeros(len(dc_vec))
        for jj, (dc, w) in enumerate(zip(dc_vec, rho)):
            if dc > 2:
                for _ in range(int(dc) - dc_tmp):
                    out_p, out_m = self._chk_update_convolve(
                        p_in_p, p_in_m, out_p, out_m
                    )
                    dc_tmp += 1
            tmp = self._pmf_orig(out_p, out_m)
            out += w * tmp
            P_row[jj] = tmp[:N].sum() + 0.5 * tmp[N]
        self.pmf_chk2var = out
        Pe = out[:N].sum() + 0.5 * out[N]
        return (P_row, Pe) if trace else None

    def _var_update_irr(self, trace=False):
        N = self.N
        out = np.zeros(2 * N + 2)
        order = np.argsort(self.ens.degree_lam)
        dv_vec = self.ens.degree_lam[order]
        lam = self.ens.lam[order]
        pmf_tmp = self.pmf_LLR.copy()
        dv_tmp = 1
        P_row = np.zeros(len(dv_vec))
        for jj, (dv, w) in enumerate(zip(dv_vec, lam)):
            if dv > 1:
                for _ in range(int(dv) - dv_tmp):
                    pmf_tmp = self._var_update_convolve(self.pmf_chk2var, pmf_tmp)
                    dv_tmp += 1
            out += w * pmf_tmp
            P_row[jj] = pmf_tmp[:N].sum() + 0.5 * pmf_tmp[N]
        self.pmf_var2chk = out
        Pe = out[:N].sum() + 0.5 * out[N]
        return (P_row, Pe) if trace else None

    # -- evolution / threshold search ----------------------------------------
    def evolve(self, thr: float, var_trace: bool = False, chk_trace: bool = False):
        """Returns (exit_code, trace_P, trace_p); exit_code > 0 iff Pe
        converged below Pe_max (LDPC_DE.cpp:671-734)."""
        if var_trace and chk_trace:
            raise ValueError("choose either variable or check node tracing")
        N = self.N
        self.pmf_LLR = np.concatenate(
            [get_gaussian_pmf(2 / thr**2, 2 / thr, 2 * N + 1, self.delta), [0.0]]
        )
        self.pmf_var2chk = self.pmf_LLR.copy()
        Pe_old = 1.0
        ni_iters = 0
        P_rows, p_elems = [], []
        for ii in range(1, self.maxiter_de):
            r = self._chk_update_irr(trace=chk_trace)
            if chk_trace:
                P_rows.append(r[0])
                p_elems.append(r[1])
            r = self._var_update_irr(trace=var_trace)
            if var_trace:
                P_rows.append(r[0])
                p_elems.append(r[1])
            Pe = self.pmf_var2chk[:N].sum() + 0.5 * self.pmf_var2chk[N]
            if Pe < self.Pe_max:
                return ii + 1, np.array(P_rows), np.array(p_elems)
            if Pe < Pe_old:
                Pe_old = Pe
            else:
                ni_iters += 1
            if ni_iters >= self.max_ni_de_iters:
                return -1, np.array(P_rows), np.array(p_elems)
        return -1, np.array(P_rows), np.array(p_elems)

    def bisec_search(self):
        """Noise-threshold bisection (LDPC_DE.cpp:49-96 semantics)."""
        lo, hi = self.thr_min, self.thr_max
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

    def get_lam2stable(self, sig: float) -> float:
        from .de import get_lam2stable_cbp

        return get_lam2stable_cbp(sig, self.ens.chk_degree_dist_dense())