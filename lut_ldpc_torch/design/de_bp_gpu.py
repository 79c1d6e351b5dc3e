"""Batched density evolution for BP on the card (port of
lut_ldpc_tpu/design/de_bp_tpu.py).

The host engine (de_bp.DEBp) is float64 and sequential over DE iterations
and sigma points.  Threshold searches evaluate evolve() at many independent
noise levels, so this module evolves a whole sigma grid at once in float32
torch ops on an explicit device:

- VN updates as batched weighted rFFT convolutions (`torch.fft`), the
  check-to-variable spectrum computed once an iteration;
- CN box-plus combinations as gathers through the host's tq/tq2 tables,
  the + and - transforms stacked in one batch;
- the band scatter of the CN combine (contribution (i, k) lands in bin
  i - k) as a gather-sum along the static diagonals: bin t sums
  contrib[t + k, k] over k through a precomputed index table, with no
  atomics, so two runs on the card give equal sums;
- the per-point exit conditions carried as masks in the loop of
  design/de_loop.py, which stops when every point has decided.

Like the JAX explorer it computes in float32 on every device, so a grid
locates the threshold to about 1e-3 in sigma; threshold() can hand the
final bracket to the f64 host engine.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.pmf import get_gaussian_pmf
from .de_bp import DEBp
from .de_loop import LoopStats, run_loop

__all__ = ["DEBpGPU", "band_sum", "band_table"]


def band_table(N: int, K: int) -> np.ndarray:
    """(N+1, K+1) flat indices into a (N+1)*(K+1) + 1 contribution row:
    entry (t, k) is (t+k, k), or the appended zero where t+k > N."""
    t = np.arange(N + 1)[:, None]
    k = np.arange(K + 1)[None, :]
    i = t + k
    return np.where(i <= N, i * (K + 1) + k, (N + 1) * (K + 1))


def band_sum(contrib: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Bins of the CN combine: (R, N+1, K+1) contributions, masked to
    k <= i, -> (R, N+1) with bin t = sum over k of contrib[t+k, k]."""
    flat = contrib.reshape(contrib.shape[0], -1)
    flat = torch.cat([flat, flat.new_zeros(flat.shape[0], 1)], dim=1)
    return flat[:, table].sum(dim=2)


class DEBpGPU:
    """Batched-evolve DE-BP engine.

    Wraps a host DEBp for its tables and grids; evolve_batch(sigmas)
    evaluates the whole batch on `device` (default the card; "cpu" where
    asked for).  Attributes a caller may change: sync_every, the
    iterations between host reads of the done flag, and graph, whether the
    loop's body is replayed as a CUDA graph (on CUDA only; default there).
    """

    def __init__(self, ens, Nb: int = 10, Lmax: float = 25.0,
                 maxiter_de: int = 1000, Pe_max: float = 1e-6,
                 max_ni_de_iters: int = 1, device="cuda"):
        self.host = DEBp(ens, Nb=Nb, Lmax=Lmax)
        self.ens = ens
        self.device = resolve_device(device)
        self.maxiter_de = int(maxiter_de)
        # f32 floor: below ~1e-7 the pmf tails are rounding noise, so a
        # tighter Pe target than 1e-6 cannot be certified in f32
        self.Pe_max = max(float(Pe_max), 1e-6)
        self.max_ni_de_iters = int(max_ni_de_iters)
        self.sync_every = 8
        self.graph = self.device.type == "cuda"
        self.stats = LoopStats()
        h = self.host
        self.N, self.delta, self.Nfft, self.K = h.N, h.delta, h.Nfft, h.K
        N, K = self.N, self.K
        dev = self.device
        # static tables (host f64 -> device constants)
        self._tq = torch.as_tensor(h.tq[:N + 1], device=dev)
        self._tq2 = torch.as_tensor(h.tq2[:N + 1], device=dev)
        self._w = torch.as_tensor(h.var_conv_weight, dtype=torch.float32, device=dev)
        ii = np.arange(N + 1)[:, None]
        kk = np.arange(K + 1)[None, :]
        self._band_mask = torch.as_tensor((kk <= ii).astype(np.float32), device=dev)
        self._band = torch.as_tensor(band_table(N, K), device=dev)
        order_c = np.argsort(ens.degree_rho)
        self._dc = [int(d) for d in ens.degree_rho[order_c]]
        self._rho = [float(x) for x in ens.rho[order_c]]
        order_v = np.argsort(ens.degree_lam)
        self._dv = [int(d) for d in ens.degree_lam[order_v]]
        self._lam = [float(x) for x in ens.lam[order_v]]

    # -- the +/- transform, stacked: rows [0, S) are +, [S, 2S) are - ------
    def _pm(self, pmf):
        """(S, 2N+2) -> (2S, N+2): pmf_plus rows over pmf_minus rows."""
        N = self.N
        hi = pmf[:, N + 1:2 * N + 1]
        lo = pmf[:, :N].flip(1)
        inf = pmf[:, 2 * N + 1:]
        plus = torch.cat([pmf[:, N:N + 1], hi + lo, inf], dim=1)
        minus = torch.cat([torch.zeros_like(inf), hi - lo, inf], dim=1)
        return torch.cat([plus, minus], dim=0)

    def _orig(self, pm):
        """(2S, N+2) stacked transforms -> (S, 2N+2) pmf."""
        N = self.N
        p, m = pm.chunk(2, dim=0)
        return torch.cat([(0.5 * (p[:, 1:N + 1] - m[:, 1:N + 1])).flip(1),
                          p[:, :1],
                          0.5 * (p[:, 1:N + 2] + m[:, 1:N + 2])], dim=1)

    def _suffix(self, v):  # (R, N+2) -> (R, N+3)
        N = self.N
        fin = v[:, :N + 1]
        s = fin.sum(dim=1, keepdim=True)
        base = torch.cat([s, s - fin[:, :N].cumsum(dim=1)], dim=1) + v[:, N + 1:]
        return torch.cat([base, torch.zeros_like(s)], dim=1)

    def _chk_conv(self, a, b):
        """Table-aided box-plus of two stacked transforms (R, N+2)."""
        N = self.N
        A, B = self._suffix(a), self._suffix(b)
        tq, tq2 = self._tq, self._tq2
        K = self.K
        contrib = (a[:, :N + 1, None] * (B[:, tq[:, 1:K + 2]] - B[:, tq[:, 0:K + 1]])
                   + b[:, :N + 1, None] * (A[:, tq2[:, 1:K + 2]] - A[:, tq2[:, 0:K + 1]]))
        c = band_sum(contrib * self._band_mask, self._band)
        # infinity mass: the + masses for both transforms (LDPC_DE.cpp:991-992)
        S = a.shape[0] // 2
        inf = (a[:S, N + 1] * b[:S, N + 1])[:, None]
        return torch.cat([c, torch.cat([inf, inf], dim=0)], dim=1)

    def _chk_update(self, v2c):
        pm_in = self._pm(v2c)
        out_pm = pm_in
        out = None
        dc_tmp = 2
        for dc, wgt in zip(self._dc, self._rho):
            for _ in range(dc - dc_tmp):
                out_pm = self._chk_conv(pm_in, out_pm)
            dc_tmp = max(dc_tmp, dc)
            term = wgt * self._orig(out_pm)
            out = term if out is None else out + term
        return out

    def _var_update(self, pmf_llr, c2v):
        N, Nfft, w = self.N, self.Nfft, self._w
        spec_c2v = torch.fft.rfft(w * c2v[:, :2 * N + 1], Nfft, dim=1)
        out = None
        pmf_tmp = pmf_llr
        dv_tmp = 1
        for dv, wgt in zip(self._dv, self._lam):
            for _ in range(dv - dv_tmp):
                b = w * pmf_tmp[:, :2 * N + 1]
                conv = torch.fft.irfft(spec_c2v * torch.fft.rfft(b, Nfft, dim=1),
                                       Nfft, dim=1)
                mid = conv[:, N:3 * N + 1] / w
                pmf_tmp = torch.cat([mid, 1.0 - mid.sum(dim=1, keepdim=True)], dim=1)
            dv_tmp = max(dv_tmp, dv)
            term = wgt * pmf_tmp
            out = term if out is None else out + term
        return out

    def _pe(self, pmf):
        N = self.N
        return pmf[:, :N].sum(dim=1) + 0.5 * pmf[:, N]

    # ------------------------------------------------------------------
    def evolve(self, pmf_llr: torch.Tensor):
        """(achieved, Pe, it) for a (S, 2N+2) float32 channel pmf batch on
        the device: `it` is the JAX program's iteration count, the last
        iteration at which a point decided (maxiter if one never did)."""
        Pe_max, max_ni, maxiter = self.Pe_max, self.max_ni_de_iters, self.maxiter_de
        S = pmf_llr.shape[0]
        dev = pmf_llr.device

        def body(state):
            it, v2c, done, Pe_old, ni, it_l = state
            v2c_new = self._var_update(pmf_llr, self._chk_update(v2c))
            Pe = self._pe(v2c_new)
            conv = Pe < Pe_max
            worse = Pe >= Pe_old  # the host BP engine counts ties as worse
            ni = torch.where(~done & worse, ni + 1, ni)
            done_new = done | conv | (ni >= max_ni)
            it_l = torch.where(done_new & ~done, it + 1, it_l)
            v2c = torch.where(done[:, None], v2c, v2c_new)
            Pe_old = torch.where(done | worse, Pe_old, Pe)
            return it + 1, v2c, done_new, Pe_old, ni, it_l

        state = (torch.zeros((), dtype=torch.int32, device=dev), pmf_llr,
                 torch.zeros(S, dtype=torch.bool, device=dev),
                 torch.ones(S, dtype=torch.float32, device=dev),
                 torch.zeros(S, dtype=torch.int32, device=dev),
                 torch.full((S,), maxiter, dtype=torch.int32, device=dev))
        _, v2c, _, _, _, it_l = run_loop(body, state, maxiter, lambda st: st[2],
                                         self.sync_every, self.graph, self.stats)
        Pe = self._pe(v2c)
        return Pe < Pe_max, Pe, it_l.max()

    def channel_pmfs(self, sigmas) -> torch.Tensor:
        """(S, 2N+2) float32 channel pmfs on the device, designed on the
        host in f64 as the host engine designs them."""
        N = self.N
        pmfs = np.stack([
            np.concatenate([
                get_gaussian_pmf(2 / s**2, 2 / s, 2 * N + 1, self.delta), [0.0]])
            for s in np.asarray(sigmas, dtype=np.float64)])
        return torch.as_tensor(pmfs.astype(np.float32), device=self.device)

    def evolve_batch(self, sigmas) -> tuple[np.ndarray, np.ndarray]:
        """(converged mask, final Pe) for each sigma."""
        ach, Pe, _ = self.evolve(self.channel_pmfs(sigmas))
        return ach.cpu().numpy(), Pe.cpu().numpy()

    def threshold(self, points: int = 17, rounds: int = 3,
                  refine_host: bool = False) -> float:
        """Coarse-to-fine batched grid search for the noise threshold.

        Each round evaluates `points` sigmas across the bracket and narrows
        it to the last-converged / first-diverged pair.  refine_host
        finishes with the f64 host engine inside the final bracket."""
        lo, hi = self.host.thr_min, self.host.thr_max
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
            self.host.set_bisec_window(lo, hi)
            _, thr = self.host.bisec_search()
            return thr if thr > 0 else lo
        return lo
