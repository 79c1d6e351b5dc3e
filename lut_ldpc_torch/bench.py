"""Headline throughput of the port on one CUDA device.

The configuration of the repository's ``bench.py``: the N=10000 rate-1/2
(3,6) quasi-cyclic code (codes/rate0.50_dv03_dc06_N10000_qc.qc.json), a
4-bit min-LUT codec designed at sigma=0.85 with 50 iterations, B=8192
frames at Eb/N0 = 2 dB, channel noise from ``np.random.default_rng(0)``,
decoded by ``make_staged_decoder``.  Metric: decoded information
throughput, Mbit/s of systematic bits through the full decode, timed with
``torch.cuda.synchronize()`` around the runs.

    python -m lut_ldpc_torch.bench [--device cuda:N]

Prints one JSON line {"metric", "value", "unit", "device"}; refuses to run
without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QC_JSON = os.path.join(REPO, "codes", "rate0.50_dv03_dc06_N10000_qc.qc.json")
DESIGN_SIGMA = 0.85
MAX_ITERS = 50
BATCH = 8192
REPS = 5


def build_codec(**design):
    """The headline codec (bench.py ``build_codec``, QC branch); `design`
    overrides keywords of ``LUTCodec.design`` (``max_iters``, ``Nq_Cha``,
    ``Nq_Msg``, ...)."""
    from .core import qc
    from .decoder.codec import LUTCodec

    graph = qc.qc_expand(qc.load_qc(QC_JSON))
    return LUTCodec.design(graph, DESIGN_SIGMA**2,
                           **{"max_iters": MAX_ITERS, "Nq_Cha": 16, "Nq_Msg": 16, **design})


def channel_labels(codec, B: int, snr_db: float = 2.0, seed: int = 0):
    """All-zero codeword over BI-AWGN at `snr_db`: (channel labels, initial
    message labels), (B, nvar) int32 numpy arrays."""
    from .ops import pmf

    sig = float(pmf.snr2sig(0.5, snr_db))
    rng = np.random.default_rng(seed)
    y = 1.0 + sig * rng.standard_normal((B, codec.nvar))
    lc, lm = codec.quantize_channel(2.0 * y / sig**2)
    return lc.astype(np.int32), lm.astype(np.int32)


def time_decode(dec, lc, lm, reps: int, warmup: int = 2, device=None):
    """Mean seconds per decode call and the last output; synchronized with
    the card of `device` (default: that of the labels lc, else the
    current one) unless it is the CPU."""
    import torch

    dev = device if device is not None else getattr(lc, "device", None)

    def sync():
        if dev is None or dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        out = dec(lc, lm)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = dec(lc, lm)
    sync()
    return (time.perf_counter() - t0) / reps, out


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the card to time (cuda, cuda:N)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("lut_ldpc_torch.bench needs a CUDA device")
    from .decoder import make_staged_decoder
    from .device import resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    codec = build_codec()
    print(f"# codec designed in {time.perf_counter() - t0:.1f}s "
          f"(N={codec.nvar}, {codec.max_iters} iters)", file=sys.stderr)
    dec = make_staged_decoder(codec, dev)
    print(f"# decoder: {type(dec).__name__}", file=sys.stderr)
    lc, lm = channel_labels(codec, BATCH)
    lc = torch.as_tensor(lc, device=dev)
    lm = torch.as_tensor(lm, device=dev)
    dt, out = time_decode(dec, lc, lm, REPS, device=dev)
    iters_mean = float(out[2].float().mean())
    info_bits = BATCH * codec.k
    mbits = info_bits / dt / 1e6
    print(f"# mean decode iterations {iters_mean:.2f}, ok "
          f"{float(out[1].float().mean()):.4f}; {BATCH} frames/"
          f"{dt * 1e3:.2f} ms -> {mbits:.2f} Mbit/s info", file=sys.stderr)
    print(json.dumps({"metric": "lut_decode_info_throughput",
                      "value": mbits, "unit": "Mbit/s",
                      "device": torch.cuda.get_device_name(dev)}))


if __name__ == "__main__":
    main()
