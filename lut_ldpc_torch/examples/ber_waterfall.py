"""BER waterfall comparison on one CUDA device: 4-bit min-LUT against float
sum-product and normalized min-sum on the PEG (3,6) N=1000 code (port of
examples/ber_waterfall.py).

The LUT decoder's waterfall should sit within a fraction of a dB of float
BP (the published LUT-LDPC result).  Writes lut_q4.npz / .json / .it,
spa.npz / .json and nms.npz / .json (the names of docs/waterfall/) and,
where matplotlib imports, waterfall.png.

    python -m lut_ldpc_torch.examples.ber_waterfall [--frames 20000]
        [--batch 256] [--snr 1.0:0.25:3.5] [--out results/waterfall]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import REPO, RESULTS

ALIST = os.path.join(REPO, "codes", "rate0.50_dv03_dc06_N1000.alist")
DESIGN_THR = 0.85
# (file name, label, BP algorithm or None for the LUT codec)
RUNS = (("lut_q4", "min-LUT q4 (50 it)", None), ("spa", "float BP (50 it)", "spa"),
        ("nms", "norm. min-sum (50 it)", "nms"))


def run_waterfall(out_dir, frames=20000, batch=256, snr="1.0:0.25:3.5", device="cuda",
                  channel=None) -> list:
    """The three runs (Nfers 200, ber_min 1e-7, zero codeword, seed 0), each
    saved in out_dir; returns [(file name, label, results, simulator)]."""
    from ..core.tanner import TannerGraph
    from ..decoder import BPDecoder, LUTCodec
    from ..sim import BERSim, BERSimConfig, LDPCConfig, SimConfig
    from ..sim.config import _parse_range

    graph = TannerGraph.from_alist(ALIST)
    snr = _parse_range(snr)

    def cfg():
        return BERSimConfig(sim=SimConfig(SNRdB=snr, Nframes=frames, Nfers=200,
                                          batch_size=batch, ber_min=1e-7),
                            ldpc=LDPCConfig(zero_codeword=True))

    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for name, label, alg in RUNS:
        if alg is None:
            print(f"designing 4-bit min-LUT codec (thr {DESIGN_THR})...")
            codec = LUTCodec.design(graph, DESIGN_THR**2, max_iters=50, Nq_Cha=16,
                                    Nq_Msg=16)
            sim = BERSim(cfg(), graph, device, codec=codec, channel=channel)
        else:
            print(f"running {label}...")
            sim = BERSim(cfg(), graph, device,
                         bp_decoder=BPDecoder(graph, device, 50, algorithm=alg),
                         channel=channel)
        res = sim.run(seed=0)
        res.save(os.path.join(out_dir, name))
        if alg is None:
            res.save_itfile(os.path.join(out_dir, f"{name}.it"))
        runs.append((name, label, res, sim))
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out", default=os.path.join(RESULTS, "waterfall"))
    ap.add_argument("--snr", default="1.0:0.25:3.5")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..sim.analysis import analyze_results

    device = resolve_device(args.device)
    runs = run_waterfall(args.out, args.frames, args.batch, args.snr, device)
    labels = [label for _, label, _, _ in runs]
    results = [res for _, _, res, _ in runs]
    try:
        import matplotlib  # noqa: F401
        plot = os.path.join(args.out, "waterfall.png")
    except ImportError:
        plot = None
    analyze_results(results, labels=labels, plot_file=plot)
    print(f"wrote {plot}" if plot else "matplotlib is not installed: no waterfall.png")

    # headline comparison at 2 dB
    snr = results[0].snr_db
    i2 = int(np.argmin(np.abs(snr - 2.0)))
    for label, r in zip(labels, results):
        print(f"  {label:24s} BER@2dB = {r.ber()[i2]:.3e}  FER = {r.fer()[i2]:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
