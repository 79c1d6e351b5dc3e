"""Result analysis: BER/FER curves, Shannon-limit bound, runtime stats
(copy of lut_ldpc_tpu/sim/analysis.py; numpy, matplotlib only to plot).

Python equivalent of scripts/analyze_results.m + aggregate_results.m: merge
per-seed result files, print seconds/frame, compute the finite-rate BER
limit curve Pb > H2^-1(1 - C(sig)/R) over the BIAWGN channel, and
optionally plot everything with matplotlib.
"""

from __future__ import annotations

import numpy as np

from .results import BERSimResults, aggregate

__all__ = ["c_biawgn", "c_awgn", "ber_limit_curve", "analyze_results"]


def c_biawgn(sig: float) -> float:
    """BIAWGN channel capacity at noise stdev sig (analyze_results.m:111)."""
    x = np.linspace(-20 * sig, 20 * sig, 100000)
    phi = (1.0 / np.sqrt(8 * np.pi * sig**2)) * (
        np.exp(-((x + 1) ** 2) / (2 * sig**2)) + np.exp(-((x - 1) ** 2) / (2 * sig**2))
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        integrand = np.where(phi > 0, phi * np.log2(phi), 0.0)
    h_y = -np.trapezoid(integrand, x)
    return h_y - 0.5 * np.log2(2 * np.pi * np.e * sig**2)


def c_awgn(sig: float) -> float:
    return 0.5 * np.log2(1 + 1 / sig**2)


def _h2(p):
    return -p * np.log2(p) - (1 - p) * np.log2(1 - p)


def _h2_inv(y: float) -> float:
    """Inverse of the binary entropy on (0, 0.5] by bisection."""
    if y <= 0:
        return 0.0
    lo, hi = 1e-16, 0.5
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _h2(mid) < y:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def ber_limit_curve(rate: float, snr_min: float = -0.01, npoints: int = 100,
                    capacity=c_biawgn):
    """(snr_db, Pb_bound): the converse BER bound Pb >= H2^-1(1 - C/R)
    (analyze_results.m:67-100)."""
    # find sig_max with C(sig_max) = rate (bisection)
    lo, hi = 1e-3, 20.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if capacity(mid) > rate:
            lo = mid
        else:
            hi = mid
    sig_max = 0.5 * (lo + hi)
    snr_max = -20 * np.log10(sig_max * np.sqrt(2 * rate))
    snr = np.linspace(snr_min, snr_max, npoints)
    pb = np.zeros(npoints)
    for i in range(npoints - 1):
        sig = 10 ** (-snr[i] / 20) / np.sqrt(2 * rate)
        pb[i] = _h2_inv(max(0.0, 1 - capacity(sig) / rate))
    pb[-1] = 1e-7
    return snr, pb


def analyze_results(paths_or_results, labels=None, plot_file: str | None = None,
                    show_limit: bool = True, verbose: bool = True):
    """Aggregate + summarize result sets; optionally plot BER/FER curves.

    Each element of paths_or_results is a BERSimResults, a path, or a list
    of per-seed paths (merged by counter summation).  Returns the list of
    merged BERSimResults.
    """
    merged = []
    for item in paths_or_results:
        if isinstance(item, BERSimResults):
            merged.append(item)
        elif isinstance(item, (list, tuple)):
            merged.append(aggregate(list(item)))
        else:
            merged.append(BERSimResults.load(item))
    if labels is None:
        labels = [f"run {i}" for i in range(len(merged))]

    if verbose:
        for name, r in zip(labels, merged):
            tot = int(r.frames.sum())
            spf = r.runtime / tot if tot else 0.0
            print(f' Average runtime for simulation "{name}" = {spf:g} s / frame')

    if plot_file:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        for name, r in zip(labels, merged):
            mask = r.frames > 0
            ax.semilogy(r.snr_db[mask], np.maximum(r.ber()[mask], 1e-12),
                        "o-", label=f"{name} BER")
            ax.semilogy(r.snr_db[mask], np.maximum(r.fer()[mask], 1e-12),
                        "s--", label=f"{name} FER")
        if show_limit and merged:
            snr, pb = ber_limit_curve(merged[0].rate)
            ax.semilogy(snr, np.maximum(pb, 1e-12), "k:", label="BIAWGN limit")
        ax.set_xlabel("Eb/N0 [dB]")
        ax.set_ylabel("error rate")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend()
        fig.tight_layout()
        fig.savefig(plot_file, dpi=120)
        plt.close(fig)
    return merged
