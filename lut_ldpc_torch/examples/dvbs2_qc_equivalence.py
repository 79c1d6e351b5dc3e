"""Statistical BER/FER equivalence of the two realizations of the DVB-S2
matrix on one CUDA device (port of examples/dvbs2_qc_equivalence.py).

The ETSI rate-1/2 matrix (codes/rate0.50_irreg_dvbs2_N64800.alist) decodes
either as the alist has it (``TannerGraph.from_alist``: the std kernels) or
in its Z=360 quasi-cyclic factorization with the pinned phantom edge
(``core.dvbs2.load_periodic_alist``: the QC kernels).  The two are one code
up to bit relabeling, with the LUT trees' leaf order following each
realization's edge order: frames differ, the waterfall must not.  Both run
with the same design sigma over the cliff region; the output holds their
counters and a two-proportion z-score of the frame errors per point.

    python -m lut_ldpc_torch.examples.dvbs2_qc_equivalence [--frames 10240]
        [--batch 1024] [--thr 0.90] [--snr 1.6,1.8,2.0]
        [--out results/waterfall] [--device cuda]

Writes <out>/dvbs2_qc_equivalence.json (the JAX script's keys).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import RESULTS
from .dvbs2_waterfall import DVBS2_ALIST as ALIST
from .dvbs2_waterfall import MEM_BUDGET


def run(graph, snrs, frames, batch, thr, device="cuda", channel=None, codec=None):
    """One realization's sweep: a q4 min-LUT codec designed on `graph` at
    sigma `thr` (50 iterations; or the given codec), zero codeword, Nfers
    1e9, skipping off, seed 0.  Returns (results, seconds, the simulator)."""
    from ..decoder.codec import LUTCodec
    from ..sim import BERSim, BERSimConfig, LDPCConfig, SimConfig

    os.environ.setdefault("LUT_DECODE_MEM_BUDGET", str(MEM_BUDGET))
    if codec is None:
        codec = LUTCodec.design(graph, thr**2, max_iters=50, Nq_Cha=16, Nq_Msg=16)
    cfg = BERSimConfig(
        sim=SimConfig(SNRdB=np.asarray(snrs, dtype=np.float64), Nframes=frames,
                      Nfers=10**9, batch_size=batch, ber_min=0.0, fer_min=0.0),
        ldpc=LDPCConfig(zero_codeword=True),
    )
    sim = BERSim(cfg, graph, device, codec=codec, channel=channel)
    t0 = time.perf_counter()
    res = sim.run(seed=0)
    return res, time.perf_counter() - t0, sim


def fer_z_scores(k1, k2, n) -> list:
    """Two-proportion z-score of frame-error counts k1[i], k2[i] out of n
    frames each, per point, rounded to 2 decimals (0 where neither has an
    error)."""
    zs = []
    for a, b in zip(k1, k2):
        p = (a + b) / (2 * n)
        se = np.sqrt(max(p * (1 - p) * 2 / n, 1e-30))
        zs.append(float((a / n - b / n) / se) if p > 0 else 0.0)
    return [round(z, 2) for z in zs]


def payload_of(snrs, frames, thr, rq, tq, rg, tg) -> dict:
    """The JSON of the JAX script from the QC run (rq, tq seconds) and the
    gather run (rg, tg)."""
    def part(res, secs):
        return {"fer": [float(x) for x in res.fer()], "ber": [float(x) for x in res.ber()],
                "frame_errors": [int(x) for x in res.frame_errors],
                "runtime_s": round(secs, 1)}

    payload = {"snr_db": [float(s) for s in snrs], "frames": int(frames), "design_thr": thr,
               "qc": part(rq, tq), "gather": part(rg, tg)}
    payload["fer_z_scores"] = fer_z_scores(payload["qc"]["frame_errors"],
                                           payload["gather"]["frame_errors"], frames)
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=10240)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--thr", type=float, default=0.90)
    ap.add_argument("--snr", default="1.6,1.8,2.0")
    ap.add_argument("--out", default=os.path.join(RESULTS, "waterfall"))
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    from ..core.dvbs2 import load_periodic_alist
    from ..core.tanner import TannerGraph
    from ..device import resolve_device

    device = resolve_device(args.device)
    snrs = [float(s) for s in args.snr.split(",")]
    gq = load_periodic_alist(ALIST)[0]
    print("# QC realization (QC kernels)...", file=sys.stderr)
    rq, tq, _ = run(gq, snrs, args.frames, args.batch, args.thr, device=device)
    gg = TannerGraph.from_alist(ALIST)
    print("# gather realization (std kernels)...", file=sys.stderr)
    rg, tg, _ = run(gg, snrs, args.frames, args.batch, args.thr, device=device)
    payload = payload_of(snrs, args.frames, args.thr, rq, tq, rg, tg)
    os.makedirs(args.out, exist_ok=True)
    out = os.path.join(args.out, "dvbs2_qc_equivalence.json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload, indent=1))
    print(f"# wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
