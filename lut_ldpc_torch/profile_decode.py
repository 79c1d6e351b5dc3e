"""Where one decode's time goes on the card.

    python -m lut_ldpc_torch.profile_decode
        [--code headline|headline-blocks|peg|qc|dvbs2|dvbs2-gather] [--reps 5]

Builds the codec and the ``make_staged_decoder`` decoder of the chosen
configuration (``headline``: lut_ldpc_torch.bench; ``headline-blocks``: the
same batch through the int16 prefix on the per-degree-block loop,
``ArithLUTDecoder(loop="blocks")``, as phase 11 of chip_smoke.py; the others:
lut_ldpc_torch.bench_n64800), warms up, then

- times --reps decodes on the host clock (synchronized), with the peak
  device memory of one decode;
- traces one decode with ``torch.profiler`` and prints device time by
  kernel name (the CN/VN kernels, the rest), the launches and time of the
  gather kernels (``index_select`` and the like), the busy total, the idle share of the span from the first to
  the last device operation, the pass kernels' share of it against the rest
  (torch glue), and for a phantom-completed graph the device
  time of the phantom row repairs (the ``lut::phantom_rows`` ranges of
  ``ArithLUTDecoder._vn``);
- prints the kernel launches of that decode per kernel and dtype.

Needs a CUDA device.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

# the kernels of the CN and VN passes (CN frames, generated VN kernels, the
# block pair, the table-driven witnesses), by their names in a trace
PASS_KERNEL = re.compile(r"\b(?:cn|vn)_(?:qc|std|block)_(?:frames_|class_)?kernel\b")


def build(code: str, dev):
    import torch

    from . import bench, bench_n64800 as b64
    from .decoder import ArithLUTDecoder, make_staged_decoder

    if code.startswith("headline"):
        codec = bench.build_codec()
        B, snr = bench.BATCH, 2.0
        dec = make_staged_decoder(codec, dev)
        if code == "headline-blocks":
            dec = ArithLUTDecoder(codec, dev, spec=dec.pre.spec, loop="blocks")
    else:
        os.environ.setdefault("LUT_DECODE_MEM_BUDGET", str(b64.MEM_BUDGET))
        codec = b64.build_codec(code)
        B, snr = b64.BATCH, b64.SNR_DB
        dec = make_staged_decoder(codec, dev, max_batch=B)
    lc, lm = bench.channel_labels(codec, B, snr)
    return dec, torch.as_tensor(lc, device=dev), torch.as_tensor(lm, device=dev)


def device_breakdown(prof):
    """(rows of (name, calls, ms), busy ms, span ms) of the device kernels
    and copies in a finished profile."""
    rows, busy, t0, t1 = {}, 0.0, None, None
    for ev in prof.events():
        # kernels and copies only: a record_function range also shows on the
        # device side, as the span of the kernels launched inside it
        if ev.device_type.name != "CUDA" or ev.name.startswith("lut::"):
            continue
        dur = ev.time_range.elapsed_us()
        start = ev.time_range.start
        t0 = start if t0 is None else min(t0, start)
        t1 = start + dur if t1 is None else max(t1, start + dur)
        calls, ms = rows.get(ev.name, (0, 0.0))
        rows[ev.name] = (calls + 1, ms + dur / 1e3)
        busy += dur / 1e3
    span = 0.0 if t0 is None else (t1 - t0) / 1e3
    return sorted(((n, c, ms) for n, (c, ms) in rows.items()),
                  key=lambda r: -r[2]), busy, span


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--code", default="peg", choices=["headline", "headline-blocks", "peg",
                                                      "qc", "dvbs2", "dvbs2-gather"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="the card to time (cuda, cuda:N)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("lut_ldpc_torch.profile_decode needs a CUDA device")
    from .decoder import qc_kernels as qk

    print("# card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device(args.device)
    dec, lc, lm = build(args.code, dev)
    inner = getattr(dec, "inner", dec)
    print(f"# {args.code}: {type(dec).__name__} (inner {type(inner).__name__}), "
          f"B={lc.shape[0]}")
    for _ in range(2):
        out = dec(lc, lm)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        out = dec(lc, lm)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"# decode ms: {' '.join(f'{t:.3f}' for t in times)}; mean iters "
          f"{float(out[2].float().mean()):.4f}, ok {float(out[1].float().mean()):.6f}; "
          f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    qk.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dec(lc, lm)
        torch.cuda.synchronize(dev)
    rows, busy, span = device_breakdown(prof)
    if busy == 0.0:
        sys.exit("the profiler recorded no device time")
    print(f"# launches: { {f'{n}/{dt}': c for (n, dt), c in qk.LAUNCHES_BY_DTYPE.items() if c} }")
    print(f"# device busy {busy:.3f} ms over a span of {span:.3f} ms: idle "
          f"{100 * (1 - busy / span):.1f} %")
    passes = sum(ms for name, _, ms in rows if PASS_KERNEL.search(name))
    print(f"# CN and VN pass kernels {passes:.3f} ms, everything else (torch glue) "
          f"{busy - passes:.3f} ms ({100 * (busy - passes) / busy:.1f} % of busy)")
    for ev in prof.key_averages():
        if ev.key == "lut::phantom_rows" and ev.device_type.name != "CUDA":
            us = getattr(ev, "device_time_total", None)
            if us is None:  # older torch
                us = ev.cuda_time_total
            print(f"# phantom row repairs: {us / 1e3:.3f} ms of device time in "
                  f"{ev.count} ranges, {100 * us / 1e3 / busy:.2f} % of busy")
    for name, calls, ms in rows[:14]:
        print(f"#   {ms:10.3f} ms {100 * ms / busy:5.1f} %  x{calls:<5d} {name[:90]}")
    rest = sum(ms for _, _, ms in rows[14:])
    print(f"#   {rest:10.3f} ms {100 * rest / busy:5.1f} %  (all other device operations)")
    # row gathers (index_select and the like) wherever they come from
    gathers = [(calls, ms) for name, calls, ms in rows if "gather" in name]
    print(f"# gather kernels: {sum(c for c, _ in gathers)} launches, "
          f"{sum(ms for _, ms in gathers):.3f} ms")


if __name__ == "__main__":
    main()
