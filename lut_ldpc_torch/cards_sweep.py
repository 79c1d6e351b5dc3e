"""A Monte-Carlo sweep in one process over several cards: ``BERSim`` over
``dp_mesh(n, "cuda")``, whose slots run at once, one host thread a card
(``parallel.run_by_device``), with every slot step's span kept.

By default the sweep of BASELINE config 5 as the four-card cell of
BENCHMARK.json (``dp4_waterfall_qc10000_q4``) runs it as four processes:
the headline codec (``lut_ldpc_torch.bench``: the N=10000 (3,6) QC code,
q4 min-LUT designed at sigma 0.85, 50 iterations), the all-zero codeword,
1.0:0.25:3.5 dB, 1e6 frames a point with no early stop, B=8192 a card;
a warm-up batch on each card first.  Prints frames/s (the frames counted
over ``BERSimResults.runtime``), each card's mean step ms at each point
(CUDA events), in how many groups the step spans of every card overlap
on the host clock, the groups' concurrency (step seconds over the
group's span: 1 where the cards take turns, n where they all run the
whole time), the card, and last one JSON line.

    python -m lut_ldpc_torch.cards_sweep [--cards N] [--frames F]
        [--snr 1.0:0.25:3.5] [--batch B] [--seed S]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .sim import BERSim

__all__ = ["SpanSim", "span_summary", "main"]

COUNTERS = ("frames", "data_bits", "uncoded_bits", "frame_errors", "data_bit_errors",
            "uncoded_bit_errors", "decode_iters")


class SpanSim(BERSim):
    """BERSim whose slot steps each keep (card, SNR index, global batch,
    host clock at the start, host clock once the card has finished the
    step, the step's ms by CUDA events on the card's current stream) in
    ``spans``; the runner's thread has made the card current."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.spans = []

    def slot_step(self, device, seed, ss, gb, sigma):
        stream = torch.cuda.current_stream(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record(stream)
        c = super().slot_step(device, seed, ss, gb, sigma)
        end.record(stream)
        end.synchronize()
        self.spans.append((str(device), int(ss), int(gb), t0, time.perf_counter(),
                           start.elapsed_time(end)))
        return c


def span_summary(spans, n: int) -> dict:
    """step_ms: card -> SNR index -> mean step ms; overlapping: groups in
    which every card's step spans share an instant, out of all groups;
    concurrency: per group, the steps' seconds over the group's span."""
    cards = sorted({s[0] for s in spans})
    points = sorted({s[1] for s in spans})
    step_ms = {c: {ss: statistics.fmean(ms for d, s, _, _, _, ms in spans
                                        if d == c and s == ss) for ss in points}
               for c in cards}
    groups = {}
    for _, ss, gb, a, b, _ in spans:
        groups.setdefault((ss, gb // n), []).append((a, b))
    overlap = sum(max(a for a, _ in g) < min(b for _, b in g) for g in groups.values())
    conc = [sum(b - a for a, b in g) / (max(b for _, b in g) - min(a for a, _ in g))
            for g in groups.values()]
    return {"step_ms": step_ms, "overlapping": [overlap, len(groups)],
            "concurrency": [min(conc), statistics.fmean(conc), max(conc)],
            "group_sizes": sorted({len(g) for g in groups.values()})}


def _snr(text: str) -> np.ndarray:
    lo, step, hi = (float(x) for x in text.split(":"))
    return lo + step * np.arange(int(np.floor((hi - lo) / step + 1e-9)) + 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=0, help="cards (default: all, up to four)")
    ap.add_argument("--frames", type=int, default=1_000_000, help="frames a point")
    ap.add_argument("--snr", default="1.0:0.25:3.5", help="Eb/N0 grid, start:step:stop dB")
    ap.add_argument("--batch", type=int, default=8192, help="frames a batch (a card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from . import bench
    from .decoder import qc_kernels as qk
    from .ops.pmf import snr2sig
    from .parallel import dp_mesh
    from .sim import BERSimConfig, LDPCConfig, SimConfig

    if not torch.cuda.is_available():
        print("cards_sweep: needs CUDA devices", file=sys.stderr)
        return 1

    n = args.cards or min(torch.cuda.device_count(), 4)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    qk.build_kernels()
    codec = bench.build_codec()
    codec.k  # the GF(2) rank, outside the timed sweep
    cfg = BERSimConfig(sim=SimConfig(SNRdB=_snr(args.snr), Nframes=args.frames,
                                     Nfers=args.frames, ber_min=0.0, fer_min=0.0,
                                     batch_size=args.batch),
                       ldpc=LDPCConfig(zero_codeword=True))
    mesh = dp_mesh(n, "cuda")
    sim = SpanSim(cfg, codec.graph, codec=codec, mesh=mesh)
    sig = float(snr2sig(sim.rate, cfg.sim.SNRdB[0]))
    sim._dp_step(args.seed, 0, sig, 10**6)  # warm-up: one batch a card
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t0
    sim.spans = []
    res = sim.run(seed=args.seed, verbose=False)
    frames = int(res.frames.sum())
    out = {"cards": n, "slots": [str(s.device) for s in mesh.slots], "frames": frames,
           "runtime_s": res.runtime, "sim_frames_per_s": frames / res.runtime,
           "setup_s": setup_s, "snr_db": cfg.sim.SNRdB.tolist(),
           "counters": {k: getattr(res, k).tolist() for k in COUNTERS},
           **span_summary(sim.spans, n), "card": smi}
    print(f"# {n} cards in one process: {frames} frames in {res.runtime:.3f} s, "
          f"{out['sim_frames_per_s']:.1f} frames/s; every card's step spans overlap in "
          f"{out['overlapping'][0]} of {out['overlapping'][1]} groups, concurrency "
          f"{out['concurrency'][0]:.3f} / {out['concurrency'][1]:.3f} / "
          f"{out['concurrency'][2]:.3f} (min / mean / max)")
    for c, per in out["step_ms"].items():
        print(f"#   {c} step ms: " + " ".join(f"{cfg.sim.SNRdB[ss]:g} dB {ms:.2f}"
                                          for ss, ms in per.items()))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
