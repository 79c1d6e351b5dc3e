"""DVB-S2-scale (N=64800) BER waterfalls on one CUDA device: BASELINE.json
config 4 (port of examples/dvbs2_waterfall.py, same runs, codes, designs,
grids and stop rules).

Five runs (``--run``):

- ``lut64800``: q4 min-LUT designed at sigma 0.90 (50 iterations) on the
  irregular dv{2,3,9,17}/dc{8,9} PEG code
  (codes/rate0.50_dv02-17_dc08-09_lut_q4_N64800.alist), SNR 0.8:0.2:1.6;
- ``lut64800_qc``: the same design on the girth-8 quasi-cyclic code of the
  same ensemble (codes/rate0.50_dv02-17_dc08-09_N64800_qc.qc.json);
- ``dvbs2_spa``: float sum-product, 50 iterations, on the ETSI DVB-S2
  rate-1/2 matrix (codes/rate0.50_irreg_dvbs2_N64800.alist), SNR
  0.6:0.2:1.4;
- ``dvbs2_lut`` / ``dvbs2_lut_qc``: the stability-limited thr-0.67 q4
  min-LUT codec on that matrix as the alist has it / in its Z=360
  quasi-cyclic form, over 0.8-3.0 dB with skipping off, and the stability
  numbers that explain the curve (lambda_2 against the min-LUT stable
  limit, ``design.de.get_lam2stable_lut``).  The codec is the stored one
  (docs/waterfall/dvbs2_N64800_lut_q4{,_qc}_codec.npz, written by the JAX
  package; read, never written), or one in --out of that name, or else
  designed here and saved into --out.

    python -m lut_ldpc_torch.examples.dvbs2_waterfall [--run lut64800]
        [--frames 100000] [--batch 2048] [--snr ...] [--out results/waterfall]
        [--device cuda]

Writes <tag>.npz / .json / .it under --out (and <tag>.json with the
stability numbers for the dvbs2_lut runs); prints each run's payload.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import REPO, RESULTS

CODES = os.path.join(REPO, "codes")
STORED = os.path.join(REPO, "docs", "waterfall")  # TPU-era curves and codecs: read only
PEG_ALIST = os.path.join(CODES, "rate0.50_dv02-17_dc08-09_lut_q4_N64800.alist")
QC_JSON = os.path.join(CODES, "rate0.50_dv02-17_dc08-09_N64800_qc.qc.json")
DVBS2_ALIST = os.path.join(CODES, "rate0.50_irreg_dvbs2_N64800.alist")
# run -> the tag of its files
TAGS = {"lut64800": "lut_dv02-17_N64800_q4", "lut64800_qc": "lut_dv02-17_N64800_qc_q4",
        "dvbs2_spa": "dvbs2_N64800_spa", "dvbs2_lut": "dvbs2_N64800_lut_q4",
        "dvbs2_lut_qc": "dvbs2_N64800_lut_q4_qc"}
# the JAX script's 512 was set by a 16 GB card; 2048 frames of N=64800
# through the staged decoder fit the H100's 80 GB with room
BATCH = 2048
# make_staged_decoder chunks a batch by budget // (E * dv_max * 2) frames;
# the port's 1 GiB default would cut an N=64800 batch into chunks of 64
MEM_BUDGET = 40 << 30
DESIGN_THR = 0.90   # lut64800 / lut64800_qc
STORED_THR = 0.67   # the dvbs2_lut codec's design sigma
THR_SIGMA = 0.684   # its strict-Pe_max DE threshold (the JAX script's figure)
SNR = {"lut64800": "0.8:0.2:1.6", "lut64800_qc": "0.8:0.2:1.6",
       "dvbs2_spa": "0.6:0.2:1.4",
       "dvbs2_lut": "0.8 1.0 1.2 1.4 1.5 1.6 1.7 1.8 2.0 2.5 3.0"}
SNR["dvbs2_lut_qc"] = SNR["dvbs2_lut"]


def graph_of(run: str):
    """The Tanner graph a run decodes."""
    from ..core.tanner import TannerGraph

    if run == "lut64800":
        return TannerGraph.from_alist(PEG_ALIST)
    if run == "lut64800_qc":
        from ..core.qc import load_qc, qc_expand

        return qc_expand(load_qc(QC_JSON))
    if run == "dvbs2_lut_qc":
        from ..core.dvbs2 import load_periodic_alist

        return load_periodic_alist(DVBS2_ALIST)[0]
    return TannerGraph.from_alist(DVBS2_ALIST)


def simulate(graph, snr, frames, batch, codec=None, bp=None, nfers=200, ber_min=1e-8,
             fer_min=1e-10, device="cuda", channel=None, out_dir=None):
    """One zero-codeword BERSim sweep, seed 0: (results, seconds, the
    simulator).  Sets LUT_DECODE_MEM_BUDGET to MEM_BUDGET where unset."""
    from ..sim import BERSim, BERSimConfig, LDPCConfig, SimConfig

    os.environ.setdefault("LUT_DECODE_MEM_BUDGET", str(MEM_BUDGET))
    cfg = BERSimConfig(
        sim=SimConfig(SNRdB=np.asarray(snr, dtype=np.float64), Nframes=frames, Nfers=nfers,
                      batch_size=batch, ber_min=ber_min, fer_min=fer_min,
                      results_dir=out_dir or "results"),
        ldpc=LDPCConfig(zero_codeword=True),
    )
    sim = BERSim(cfg, graph, device, codec=codec, bp_decoder=bp, channel=channel)
    t0 = time.time()
    res = sim.run(seed=0)
    return res, time.time() - t0, sim


def write_run(tag, res, seconds, snr, out_dir) -> dict:
    """Save a run's results as <tag>.npz / .json and <tag>.it; returns the
    JAX script's payload."""
    os.makedirs(out_dir, exist_ok=True)
    res.save(os.path.join(out_dir, tag))
    res.save_itfile(os.path.join(out_dir, f"{tag}.it"))
    payload = {
        "snr_db": [float(x) for x in snr],
        "frames": [int(x) for x in res.frames],
        "frame_errors": [int(x) for x in res.frame_errors],
        "ber": [float(x) for x in res.ber()],
        "fer": [float(x) for x in res.fer()],
        "runtime_s": round(seconds, 1),
    }
    print(tag, json.dumps(payload, indent=1))
    return payload


def run_one(tag, graph, snr, frames, batch, out_dir, codec=None, bp=None, nfers=200,
            ber_min=1e-8, fer_min=1e-10, device="cuda", channel=None) -> dict:
    """Simulate and save one waterfall (the JAX script's ``run_one``);
    exactly one of codec (LUT) and bp (a BPDecoder on `device`)."""
    res, seconds, _ = simulate(graph, snr, frames, batch, codec=codec, bp=bp, nfers=nfers,
                               ber_min=ber_min, fer_min=fer_min, device=device,
                               channel=channel, out_dir=out_dir)
    return write_run(tag, res, seconds, snr, out_dir)


def stability(graph) -> dict:
    """The profile's degree-2 edge mass against the q4 min-LUT stable limit
    at 1 dB (design/de.py get_lam2stable_lut), with the stored design's
    sigma and DE threshold."""
    from ..design.de import get_lam2stable_lut
    from ..ops.pmf import sig2snr, snr2sig

    ens = graph.empirical_ensemble()
    lam2 = float(dict(zip(ens.degree_lam.tolist(), ens.lam.tolist())).get(2, 0.0))
    sig_op = float(snr2sig(0.5, 1.0))
    lam2_star = float(get_lam2stable_lut(sig_op, ens.chk_degree_dist_dense(), 16, 16))
    return dict(lam2=lam2, lam2_stable_at_1dB=lam2_star, design_thr=STORED_THR,
                thr_sigma=THR_SIGMA, thr_snr_db=round(float(sig2snr(0.5, THR_SIGMA)), 2))


def stored_codec(graph, qc_tag: str, out_dir: str):
    """The thr-0.67 codec: a file of its name in out_dir, else the stored
    one in docs/waterfall, else designed on `graph` and saved in out_dir."""
    from ..decoder.codec import LUTCodec

    name = f"dvbs2_N64800_lut_q4{qc_tag}_codec.npz"
    for path in (os.path.join(out_dir, name), os.path.join(STORED, name)):
        if os.path.exists(path):
            print(f"loading codec {path} ...")
            return LUTCodec.load(path)
    print("designing q4 min-LUT codec on the standard matrix "
          f"(thr {STORED_THR}, stability-limited profile)...")
    codec = LUTCodec.design(graph, STORED_THR**2, max_iters=50, Nq_Cha=16, Nq_Msg=16)
    os.makedirs(out_dir, exist_ok=True)
    codec.save(os.path.join(out_dir, name))
    return codec


def run_dvbs2_lut(graph, codec, snr, frames, batch, out_dir, qc_tag="", device="cuda",
                  channel=None):
    """The dvbs2_lut run: every point holds real frames (skipping off, Nfers
    at least 10000); the payload with the stability numbers is written to
    <tag>.json.  Returns (payload, results, seconds, simulator)."""
    tag = TAGS["dvbs2_lut" + qc_tag]
    res, seconds, sim = simulate(graph, snr, frames, batch, codec=codec,
                                 nfers=max(10000, frames // 2), ber_min=0.0, fer_min=0.0,
                                 device=device, channel=channel, out_dir=out_dir)
    payload = write_run(tag, res, seconds, snr, out_dir)
    payload.update(stability(graph))
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(payload, f, indent=1)
    print("stability:", {"lam2": payload["lam2"], "lam2*": payload["lam2_stable_at_1dB"]})
    return payload, res, seconds, sim


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", default="lut64800", choices=list(TAGS))
    ap.add_argument("--frames", type=int, default=100000)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--out", default=os.path.join(RESULTS, "waterfall"))
    ap.add_argument("--snr", default="")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..sim.config import _parse_range

    device = resolve_device(args.device)
    os.environ.setdefault("LUT_DECODE_MEM_BUDGET", str(MEM_BUDGET))
    os.makedirs(args.out, exist_ok=True)
    graph = graph_of(args.run)
    snr = _parse_range(args.snr or SNR[args.run])
    if args.run in ("lut64800", "lut64800_qc"):
        from ..decoder.codec import LUTCodec

        print(f"designing q4 min-LUT codec at thr {DESIGN_THR} (50 iters)...")
        codec = LUTCodec.design(graph, DESIGN_THR**2, max_iters=50, Nq_Cha=16, Nq_Msg=16)
        run_one(TAGS[args.run], graph, snr, args.frames, args.batch, args.out,
                codec=codec, device=device)
    elif args.run == "dvbs2_spa":
        from ..decoder.bp import BPDecoder

        run_one(TAGS[args.run], graph, snr, args.frames, args.batch, args.out,
                bp=BPDecoder(graph, device, 50, algorithm="spa"), device=device)
    else:
        qc_tag = "_qc" if args.run == "dvbs2_lut_qc" else ""
        codec = stored_codec(graph, qc_tag, args.out)
        run_dvbs2_lut(graph, codec, snr, args.frames, args.batch, args.out, qc_tag,
                      device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
