"""LDPC degree-distribution ensembles (edge perspective).

Sparse lambda/rho representation, `.ens` file I/O, `.deg` export for PEG and
empirical extraction from a parity matrix.  Mirrors
reference src/LDPC_Ensemble.{hpp,cpp}; file formats are identical so
the shipped `ensembles/*.ens` assets load unchanged.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

PMASS_TOLERANCE = 1e-2  # LDPC_Ensemble.cpp:42


@dataclass
class LDPCEnsemble:
    """Edge-perspective degree distributions lambda (VN) and rho (CN).

    degree_lam/degree_rho hold the active (nonzero-mass) degrees; lam/rho
    the corresponding edge-fraction masses (normalized on construction).
    """

    degree_lam: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    lam: np.ndarray = field(default_factory=lambda: np.zeros(0))
    degree_rho: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    rho: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def __post_init__(self):
        self.degree_lam = np.asarray(self.degree_lam, dtype=np.int64)
        self.degree_rho = np.asarray(self.degree_rho, dtype=np.int64)
        self.lam = np.asarray(self.lam, dtype=np.float64)
        self.rho = np.asarray(self.rho, dtype=np.float64)
        if len(self.lam):
            self.check_consistency()

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_dense(cls, l: np.ndarray, r: np.ndarray) -> "LDPCEnsemble":
        """From dense degree-indexed vectors (index i = degree i+1)."""
        l = np.asarray(l, dtype=np.float64)
        r = np.asarray(r, dtype=np.float64)
        dl = np.nonzero(l > 0)[0] + 1
        dr = np.nonzero(r > 0)[0] + 1
        return cls(dl, l[dl - 1], dr, r[dr - 1])

    @classmethod
    def read(cls, path: str) -> "LDPCEnsemble":
        """Parse the 5-line `.ens` format (ensembles/README.md)."""
        with open(path) as f:
            return cls.from_stream(f)

    @classmethod
    def from_stream(cls, f: io.TextIOBase) -> "LDPCEnsemble":
        dv_act, dc_act = (int(x) for x in f.readline().split()[:2])
        if dv_act <= 0 or dc_act <= 0:
            raise ValueError("ensemble: wrong active degree data")
        dl = np.array([int(x) for x in f.readline().split()[:dv_act]], dtype=np.int64)
        lam = np.array([float(x) for x in f.readline().split()[:dv_act]])
        dr = np.array([int(x) for x in f.readline().split()[:dc_act]], dtype=np.int64)
        rho = np.array([float(x) for x in f.readline().split()[:dc_act]])
        if np.any(dl < 1) or np.any(dr < 1) or np.any(lam <= 0) or np.any(rho <= 0):
            raise ValueError("ensemble: invalid degrees or masses")
        return cls(dl, lam, dr, rho)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(f"{len(self.degree_lam)} {len(self.degree_rho)}\n")
            f.write(" ".join(str(d) for d in self.degree_lam) + "\n")
            f.write(" ".join(f"{x:g}" for x in self.lam) + "\n")
            f.write(" ".join(str(d) for d in self.degree_rho) + "\n")
            f.write(" ".join(f"{x:g}" for x in self.rho) + "\n")

    def export_deg(self, path: str) -> None:
        """Node-perspective VN distribution for the PEG generator."""
        Lam = self.Lam_node()
        with open(path, "w") as f:
            f.write(f"{len(self.degree_lam)}\n")
            f.write(" ".join(str(d) for d in self.degree_lam) + "\n")
            f.write(" ".join(f"{x:g}" for x in Lam) + "\n")

    # -- consistency (LDPC_Ensemble.cpp:93-132) ------------------------------
    def check_consistency(self) -> None:
        if np.any(self.lam < 0) or np.any(self.rho < 0):
            raise ValueError("ensemble: degree distributions must be nonnegative")
        if len(np.unique(self.degree_lam)) != len(self.degree_lam) or len(
            np.unique(self.degree_rho)
        ) != len(self.degree_rho):
            raise ValueError("ensemble: degrees must be unique")
        sl, sr = self.lam.sum(), self.rho.sum()
        if abs(1 - sl) >= PMASS_TOLERANCE and abs(1 - sr) >= PMASS_TOLERANCE:
            raise ValueError("ensemble: degree distributions do not sum to one")
        self.lam = self.lam / sl
        self.rho = self.rho / sr
        if self.rate() <= 0:
            raise ValueError("ensemble: code rate is negative")

    # -- accessors -----------------------------------------------------------
    @property
    def dv_act(self) -> int:
        return len(self.degree_lam)

    @property
    def dc_act(self) -> int:
        return len(self.degree_rho)

    def rate(self) -> float:
        """1 - sum(rho_i/d_i) / sum(lam_i/d_i) (LDPC_Ensemble.cpp:320)."""
        return 1.0 - (self.rho / self.degree_rho).sum() / (self.lam / self.degree_lam).sum()

    def Lam_node(self) -> np.ndarray:
        """Node-perspective VN degree distribution."""
        Lam = self.lam / self.degree_lam
        return Lam / Lam.sum()

    def Rho_node(self) -> np.ndarray:
        Rho = self.rho / self.degree_rho
        return Rho / Rho.sum()

    def __str__(self) -> str:
        """ASCII degree-distribution tables (the reference's TextTable-based
        operator<<, LDPC_Ensemble.cpp:425-459)."""

        def table(rows):
            widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
            rule = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
            out = [rule]
            for r in rows:
                out.append(
                    "|" + "|".join(f" {c.ljust(w)} " for c, w in zip(r, widths)) + "|"
                )
                out.append(rule)
            return "\n".join(out)

        l = table([
            ["VN degrees"] + [str(int(d)) for d in self.degree_lam],
            ["VN edge pmf"] + [f"{x:g}" for x in self.lam],
        ])
        r = table([
            ["CN degrees"] + [str(int(d)) for d in self.degree_rho],
            ["CN edge pmf"] + [f"{x:g}" for x in self.rho],
        ])
        return l + "\n" + r

    def chk_degree_dist_dense(self) -> np.ndarray:
        r = np.zeros(int(self.degree_rho.max()))
        r[self.degree_rho - 1] = self.rho
        return r

    def var_degree_dist_dense(self) -> np.ndarray:
        l = np.zeros(int(self.degree_lam.max()))
        l[self.degree_lam - 1] = self.lam
        return l


def empirical_ensemble(dv_vec: np.ndarray, dc_vec: np.ndarray) -> LDPCEnsemble:
    """Edge-perspective empirical ensemble from per-node degrees
    (LDPC_Ensemble.cpp:391-423)."""
    dv_vec = np.asarray(dv_vec, dtype=np.int64)
    dc_vec = np.asarray(dc_vec, dtype=np.int64)
    max_deg = 200
    var_edge = np.zeros(max_deg)
    chk_edge = np.zeros(max_deg)
    np.add.at(var_edge, dv_vec - 1, dv_vec.astype(np.float64))
    np.add.at(chk_edge, dc_vec - 1, dc_vec.astype(np.float64))
    return LDPCEnsemble.from_dense(var_edge / var_edge.sum(), chk_edge / chk_edge.sum())
