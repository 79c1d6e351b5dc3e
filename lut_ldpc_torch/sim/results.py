"""BER simulation results: per-SNR counters, persistence, aggregation
(copy of lut_ldpc_tpu/sim/results.py; numpy only).

Schema follows the reference's results file (write_itfile, the
reference's src/LDPC_BER_Sim.cpp:342-362): named int64 counter vectors
per SNR point plus code metadata, runtime and a provenance stamp.  Stored as
npz (+ a JSON sidecar summary); aggregate() merges per-seed files by summing
counters like scripts/aggregate_results.m:26-87.
"""

from __future__ import annotations

import json
import subprocess
from dataclasses import dataclass, field

import numpy as np

__all__ = ["BERSimResults", "aggregate", "git_version"]


def git_version(repo: str | None = None) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=repo or None,
        )
        return out.stdout.strip() or "unknown"
    except Exception:
        return "unknown"


@dataclass
class BERSimResults:
    snr_db: np.ndarray
    nvar: int
    nchk: int
    rate: float
    # per-SNR int64 counters (accumulated as python ints, stored int64)
    frames: np.ndarray = field(default=None)
    data_bits: np.ndarray = field(default=None)
    uncoded_bits: np.ndarray = field(default=None)
    frame_errors: np.ndarray = field(default=None)
    data_bit_errors: np.ndarray = field(default=None)
    uncoded_bit_errors: np.ndarray = field(default=None)
    decode_iters: np.ndarray = field(default=None)  # summed decoder iterations
    runtime: float = 0.0
    gitversion: str = ""

    def __post_init__(self):
        n = len(self.snr_db)
        for name in (
            "frames", "data_bits", "uncoded_bits", "frame_errors",
            "data_bit_errors", "uncoded_bit_errors", "decode_iters",
        ):
            if getattr(self, name) is None:
                setattr(self, name, np.zeros(n, dtype=np.int64))

    def add_counts(self, ss: int, frames, data_bits, uncoded_bits,
                   frame_errors, data_bit_errors, uncoded_bit_errors,
                   decode_iters=0):
        self.frames[ss] += frames
        self.data_bits[ss] += data_bits
        self.uncoded_bits[ss] += uncoded_bits
        self.frame_errors[ss] += frame_errors
        self.data_bit_errors[ss] += data_bit_errors
        self.uncoded_bit_errors[ss] += uncoded_bit_errors
        self.decode_iters[ss] += decode_iters

    # -- derived -------------------------------------------------------------
    def ber(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(self.data_bits > 0, self.data_bit_errors / self.data_bits, 0.0)

    def fer(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(self.frames > 0, self.frame_errors / self.frames, 0.0)

    def uncoded_ber(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(
                self.uncoded_bits > 0, self.uncoded_bit_errors / self.uncoded_bits, 0.0
            )

    def mean_iters(self) -> np.ndarray:
        """Mean decoder iterations per frame per SNR point."""
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(self.frames > 0, self.decode_iters / self.frames, 0.0)

    def sec_per_frame(self) -> float:
        tot = int(self.frames.sum())
        return self.runtime / tot if tot else 0.0

    # -- persistence (schema names follow LDPC_BER_Sim.cpp:342-362) ----------
    def save(self, path: str) -> None:
        np.savez(
            path,
            sim_SNRdB=self.snr_db,
            sim_Nframes=self.frames,
            sim_Ndatabits=self.data_bits,
            sim_Nuncodedbits=self.uncoded_bits,
            sim_frame_errors=self.frame_errors,
            sim_data_bit_errors=self.data_bit_errors,
            sim_uncoded_bit_errors=self.uncoded_bit_errors,
            sim_decode_iters=self.decode_iters,
            ldpc_nvar=np.int64(self.nvar),
            ldpc_nchk=np.int64(self.nchk),
            ldpc_rate=np.float64(self.rate),
            runtime=np.float64(self.runtime),
            gitversion=np.str_(self.gitversion),
        )
        summary = {
            "snr_db": self.snr_db.tolist(),
            "ber": self.ber().tolist(),
            "fer": self.fer().tolist(),
            "uncoded_ber": self.uncoded_ber().tolist(),
            "frames": self.frames.tolist(),
            "mean_iters": self.mean_iters().tolist(),
            "runtime_s": self.runtime,
            "sec_per_frame": self.sec_per_frame(),
            "gitversion": self.gitversion,
        }
        with open(str(path).removesuffix(".npz") + ".json", "w") as f:
            json.dump(summary, f, indent=1)

    def save_itfile(self, path: str) -> None:
        """Write the reference's .it results schema (LDPC_BER_Sim.cpp:342-362)
        so scripts/aggregate_results.m and analyze_results.m consume our
        results unchanged (counters stored as double vectors, like the
        reference's to_vec conversion)."""
        from ..utils.itfile import itsave

        itsave(path, {
            "sim_SNRdB": self.snr_db.astype(np.float64),
            "sim_Nframes": self.frames.astype(np.float64),
            "sim_Ndatabits": self.data_bits.astype(np.float64),
            "sim_frame_errors": self.frame_errors.astype(np.float64),
            "sim_data_bit_errors": self.data_bit_errors.astype(np.float64),
            "sim_uncoded_bit_errors": self.uncoded_bit_errors.astype(np.float64),
            "ldpc_nvar": np.array([float(self.nvar)]),
            "ldpc_nchk": np.array([float(self.nchk)]),
            "ldpc_code_rate": np.array([self.rate]),
            "runtime": float(self.runtime),
            "gitversion": self.gitversion,
        })

    @classmethod
    def load_itfile(cls, path: str) -> "BERSimResults":
        """Read a results .it file (ours or one written by the reference)."""
        from ..utils.itfile import itload

        z = itload(path)
        r = cls(
            snr_db=np.asarray(z["sim_SNRdB"], dtype=np.float64),
            nvar=int(np.atleast_1d(z["ldpc_nvar"])[0]),
            nchk=int(np.atleast_1d(z["ldpc_nchk"])[0]),
            rate=float(np.atleast_1d(z["ldpc_code_rate"])[0]),
            frames=np.asarray(z["sim_Nframes"]).astype(np.int64),
            data_bits=np.asarray(z["sim_Ndatabits"]).astype(np.int64),
            frame_errors=np.asarray(z["sim_frame_errors"]).astype(np.int64),
            data_bit_errors=np.asarray(z["sim_data_bit_errors"]).astype(np.int64),
            uncoded_bit_errors=np.asarray(z["sim_uncoded_bit_errors"]).astype(np.int64),
            runtime=float(z.get("runtime", 0.0)),
            gitversion=str(z.get("gitversion", "")),
        )
        # the reference schema does not store uncoded bit totals
        r.uncoded_bits = r.frames * r.nvar
        return r

    @classmethod
    def load(cls, path: str) -> "BERSimResults":
        z = np.load(path, allow_pickle=False)
        return cls(
            snr_db=z["sim_SNRdB"],
            nvar=int(z["ldpc_nvar"]),
            nchk=int(z["ldpc_nchk"]),
            rate=float(z["ldpc_rate"]),
            frames=z["sim_Nframes"].astype(np.int64),
            data_bits=z["sim_Ndatabits"].astype(np.int64),
            uncoded_bits=z["sim_Nuncodedbits"].astype(np.int64),
            frame_errors=z["sim_frame_errors"].astype(np.int64),
            data_bit_errors=z["sim_data_bit_errors"].astype(np.int64),
            uncoded_bit_errors=z["sim_uncoded_bit_errors"].astype(np.int64),
            decode_iters=(z["sim_decode_iters"].astype(np.int64)
                          if "sim_decode_iters" in z.files else None),
            runtime=float(z["runtime"]),
            gitversion=str(z["gitversion"]),
        )


def aggregate(paths: list[str], check_gitversion: bool = True) -> BERSimResults:
    """Merge per-seed result files by summing counters
    (scripts/aggregate_results.m:26-87 semantics: SNR grids must match,
    differing gitversions warn)."""
    import warnings

    out = None
    for p in paths:
        r = BERSimResults.load(p)
        if out is None:
            out = r
            continue
        if len(r.snr_db) != len(out.snr_db) or not np.allclose(r.snr_db, out.snr_db):
            raise ValueError(f"aggregate: SNR grid of {p} differs")
        if check_gitversion and r.gitversion != out.gitversion:
            warnings.warn(f"aggregate: gitversion mismatch in {p}")
        for name in (
            "frames", "data_bits", "uncoded_bits", "frame_errors",
            "data_bit_errors", "uncoded_bit_errors", "decode_iters",
        ):
            setattr(out, name, getattr(out, name) + getattr(r, name))
        out.runtime += r.runtime
    if out is None:
        raise ValueError("aggregate: no input files")
    return out
