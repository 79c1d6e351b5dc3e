"""N=64800 irregular decode throughput of the port on one CUDA device.

Counterpart of examples/bench_n64800.py.  Two constructions of the rate-1/2
dv{2,3,9,17}/dc{8,9} ensemble:

- ``--code peg``: the unstructured PEG code
  (codes/rate0.50_dv02-17_dc08-09_lut_q4_N64800.alist): the std-layout
  kernels, the permutation inside the CN kernel's loads and stores;
- ``--code qc``: the girth-8 irregular quasi-cyclic code
  (codes/rate0.50_dv02-17_dc08-09_N64800_qc.qc.json): the QC kernels;

and the ETSI DVB-S2 rate-1/2 standard matrix
(codes/rate0.50_irreg_dvbs2_N64800.alist):

- ``--code dvbs2``: permuted to its Z=360 quasi-cyclic form with one phantom
  completion edge (core/dvbs2.py): the QC kernels, with the phantom rows
  repaired around them;
- ``--code dvbs2-gather``: the same matrix as the alist has it (a degree-1
  variable, no phantom): the std-layout kernels.

A 4-bit min-LUT codec designed at sigma = --thr with --iters iterations,
--batch frames of the all-zero codeword at Eb/N0 = --snr dB, noise from
``np.random.default_rng(0)``, decoded by ``make_staged_decoder``.  Metric:
decoded information throughput, Mbit/s, timed with
``torch.cuda.synchronize()`` around --reps calls after 2 warm-up calls.

    python -m lut_ldpc_torch.bench_n64800 [--code peg|qc|dvbs2|dvbs2-gather]
        [--batch 4096] [--snr 1.6] [--reps 3] [--thr 0.90] [--iters 50]
        [--device cuda]

Prints one JSON line with the metric ``n64800_<code>_decode_info_throughput``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEG_ALIST = os.path.join(REPO, "codes", "rate0.50_dv02-17_dc08-09_lut_q4_N64800.alist")
QC_JSON = os.path.join(REPO, "codes", "rate0.50_dv02-17_dc08-09_N64800_qc.qc.json")
DVBS2_ALIST = os.path.join(REPO, "codes", "rate0.50_irreg_dvbs2_N64800.alist")
BATCH = 4096  # make_staged_decoder's default max_batch
SNR_DB = 1.6
DESIGN_THR = 0.90
MAX_ITERS = 50
# make_staged_decoder chunks a batch by budget // (E * dv_max * 2) frames
# (9.53 MB a frame here).  40 GiB admits 4096 frames in one call; the card
# holds them: see PERF.md for the measured peak.
MEM_BUDGET = 40 << 30


def build_graph(code: str):
    from .core import qc
    from .core.tanner import TannerGraph

    if code == "peg":
        return TannerGraph.from_alist(PEG_ALIST)
    if code == "qc":
        return qc.qc_expand(qc.load_qc(QC_JSON))
    if code == "dvbs2":
        from .core.dvbs2 import load_periodic_alist

        return load_periodic_alist(DVBS2_ALIST)[0]
    if code == "dvbs2-gather":
        return TannerGraph.from_alist(DVBS2_ALIST)
    raise ValueError(f"unknown code {code!r}")


def unpermuted_graph(graph):
    """The TRUE matrix of a ``load_periodic_alist`` graph back in the alist's
    own numbering, each variable's edges in the order the permuted graph
    holds them and the phantom edges left out.  A VN tree's output depends
    on the order of its inputs, so only this realization of the unpermuted
    matrix decodes frame for frame like the permuted one (labels carried
    through ``graph.qc_col_perm``); ``TannerGraph.from_alist`` keeps the
    file's order and agrees with it statistically."""
    import numpy as np

    from .core.tanner import TannerGraph

    starts = np.concatenate([[0], np.cumsum(graph.dv_vec)])
    chk_of_edge = np.empty(graph.num_edges, np.int64)
    for d in graph.cn_degrees:
        chk_of_edge[graph.cn_edge_idx[int(d)]] = graph.cn_node_idx[int(d)][:, None]
    phantom = {p["edge"] for p in graph.phantoms}
    inv_row = np.argsort(graph.qc_row_perm)
    cols = []
    for v in graph.qc_col_perm:
        edges = [e for e in range(starts[v], starts[v + 1]) if e not in phantom]
        cols.append(inv_row[chk_of_edge[edges]])
    return TannerGraph.from_cols(cols, graph.nvar, graph.nchk)


def build_codec(code: str, thr: float = DESIGN_THR, iters: int = MAX_ITERS):
    from .decoder.codec import LUTCodec

    return LUTCodec.design(build_graph(code), thr**2, max_iters=iters,
                           Nq_Cha=16, Nq_Msg=16)


def info_bits(code: str, thr: float = DESIGN_THR, iters: int = MAX_ITERS):
    """(k, seconds): the codec's information length, whose GF(2) rank takes
    minutes at this size; a function of its own so that a caller can leave
    it to a worker process."""
    codec = build_codec(code, thr, iters)
    t0 = time.perf_counter()
    return codec.k, time.perf_counter() - t0


def golden_frame(code: str, llr_cha, llr_msg, thr: float = DESIGN_THR,
                 iters: int = MAX_ITERS):
    """(bits, iters, seconds) of the scalar golden model on one frame of
    labels, on a codec designed here (for a worker process)."""
    codec = build_codec(code, thr, iters)
    t0 = time.perf_counter()
    bits, it = codec.decode_ref(llr_cha, llr_msg)
    return bits, it, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--code", default="peg",
                    choices=["qc", "peg", "dvbs2", "dvbs2-gather"])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--snr", type=float, default=SNR_DB)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--thr", type=float, default=DESIGN_THR)
    ap.add_argument("--iters", type=int, default=MAX_ITERS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from . import bench
    from .decoder import make_staged_decoder
    from .device import resolve_device

    dev = resolve_device(args.device)
    os.environ.setdefault("LUT_DECODE_MEM_BUDGET", str(MEM_BUDGET))

    t0 = time.perf_counter()
    codec = build_codec(args.code, args.thr, args.iters)
    print(f"# codec designed in {time.perf_counter() - t0:.1f}s "
          f"(nvar={codec.nvar}, nchk={codec.nchk})", file=sys.stderr)
    t0 = time.perf_counter()
    dec = make_staged_decoder(codec, dev, max_batch=args.batch)
    inner = getattr(dec, "inner", dec)
    print(f"# decoder: {type(dec).__name__} (inner {type(inner).__name__}) "
          f"built in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    t0 = time.perf_counter()
    k = codec.k
    print(f"# k={k} (rank in {time.perf_counter() - t0:.1f}s)", file=sys.stderr)

    B = args.batch
    lc, lm = bench.channel_labels(codec, B, args.snr)
    lc = torch.as_tensor(lc, device=dev)
    lm = torch.as_tensor(lm, device=dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    dt, out = bench.time_decode(dec, lc, lm, args.reps, device=dev)
    iters_mean = float(out[2].float().mean())
    ok = float(out[1].float().mean())
    mbits = B * k / dt / 1e6
    print(f"# mean iters {iters_mean:.1f}, ok {ok:.4f}; {B} frames/"
          f"{dt * 1e3:.1f} ms -> {mbits:.1f} Mbit/s info", file=sys.stderr)
    if on_card:
        print(f"# peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              file=sys.stderr)
    print(json.dumps({
        "metric": f"n64800_{args.code}_decode_info_throughput",
        "value": round(mbits, 2), "unit": "Mbit/s",
        "snr_db": args.snr, "batch": B, "mean_iters": round(iters_mean, 1),
        "ok": ok,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }))


if __name__ == "__main__":
    main()
