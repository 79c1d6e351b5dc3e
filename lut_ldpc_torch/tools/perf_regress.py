"""Per-kernel and end-to-end performance regression ledger of the port on one
CUDA device: the counterpart of tools/perf_regress.py.

    python -m lut_ldpc_torch.tools.perf_regress record [--ledger PATH] [--device cuda]
    python -m lut_ldpc_torch.tools.perf_regress check [--tol 0.12] [--ledger PATH]

``record`` measures the metrics below on the card and appends one entry to
the ledger, docs/perf/kernels_torch.json unless --ledger names another file
(docs/perf/kernels.json holds the TPU's records and stays theirs).  It
refuses to run without a CUDA device: a CPU time under these names would
mislead.  An entry holds the revision (git's short HEAD, else a digest of
the package's sources), the time, the card (name and power limit from
nvidia-smi, torch and CUDA versions) and the metrics.  ``check`` compares the
newest entry with the earlier entries of the same card at the same power
limit (``device.name`` and ``device.power_limit``) and exits non-zero when
a gated metric decays by more than --tol against the best of the last three
(compile_s and build_s: by more than COMPILE_TOL against their median).

Metrics (the JAX tool's, under its names, measuring the same work):
  n10000_fused_ms    (3,6) N=10000 QC code, q4 codec at sigma 0.85: cn_qc_pass
                     -> vn_qc_pass chained 16 times at B=8192, ms an iteration
  n64800_fused_ms    the irregular dv02-17 N=64800 QC code at 0.90, B=1024,
                     8 iterations
  headline_decode_ms make_staged_decoder on the headline codec, B=8192, 2 dB
  compile_s          host clock over building that decoder and its first
                     two calls, its generated VN units compiled cold into a
                     temporary directory inside the window (the port's
                     counterpart of XLA's compile: the decoder compiles its
                     units when it is built); compile_vn_units: how many,
                     compile_units_s: each one's nvcc seconds.  The same in
                     a fresh process and after other decodes, but for the
                     first call's set-up (a few tenths of a second)
  dvbs2_decode_ms    ArithLUTDecoder on the DVB-S2 rate-1/2 matrix in its
                     Z=360 form, B=1024, 1.6 dB, designed at 0.90
  peg_decode_ms      the same on the PEG N=64800 code
  build_s            the kernel library's units (qc_kernels.UNITS) compiled
                     cold side by side into a temporary directory, wall
                     seconds (build_units_s: each unit's)

Kernel and decode times are CUDA-event times, the minimum of 3 (5 for the
headline) after 2 warm-ups.  The decodes draw their frames from one
``np.random.default_rng(0)`` in the JAX tool's order (headline, DVB-S2,
PEG), so both tools decode the same frames.  The fused chains feed each
pass's output to the next, as the JAX tool's scan does; the port's message
arrays have no halo planes, so nothing is copied between the passes (the
JAX tool's caveat that its scan copies the full halo state does not apply
here).  The two fused metrics stay ungated all the same, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LEDGER = os.path.join(ROOT, "docs", "perf", "kernels_torch.json")
N10000_QC = os.path.join(ROOT, "codes", "rate0.50_dv03_dc06_N10000_qc.qc.json")

# gated: the end-to-end decodes, and the two compile times under the looser
# COMPILE_TOL (a 2x jump is what the JAX tool was built to catch)
METRICS = ("headline_decode_ms", "dvbs2_decode_ms", "peg_decode_ms", "compile_s",
           "build_s")
COMPILE_METRICS = ("compile_s", "build_s")
COMPILE_TOL = 1.0


def _rev() -> str:
    """git's short HEAD, else ``src-`` and a digest of the package's sources
    (a checkout without git: the same sources give the same name)."""
    try:
        return subprocess.check_output(["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
                                       stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        pass
    from ..decoder.nvcc import digest

    pkg = os.path.join(ROOT, "lut_ldpc_torch")
    parts = []
    for dirpath, dirs, names in sorted(os.walk(pkg)):
        dirs.sort()
        for n in sorted(names):
            if n.endswith((".py", ".cu", ".cuh", ".h", ".cpp")):
                with open(os.path.join(dirpath, n), "rb") as f:
                    parts += [os.path.relpath(os.path.join(dirpath, n), pkg).encode(), f.read()]
    return "src-" + digest(parts)[:12]


def device_info() -> dict:
    """The card's name and power limit (nvidia-smi) and the torch / CUDA
    versions."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in smi.rsplit(",", 1))
    return {"name": name, "power_limit": power, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def _timeit(fn, device, reps: int = 3, warmup: int = 2) -> float:
    """Seconds of one call of fn on the card `device`: CUDA events on its
    current stream around each of `reps` calls after `warmup`, the minimum
    (a mean under host load reads phantom regressions)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    stream = torch.cuda.current_stream(device)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        fn()
        end.record(stream)
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def fused_decoder(codec, device):
    """The ArithLUTDecoder of the fused harness: the int16 prefix spec, the
    float32 one where int16 cannot hold it."""
    from ..decoder import ArithBuildError, ArithLUTDecoder, build_arith_prefix_spec

    try:
        spec = build_arith_prefix_spec(codec, dtype=np.int16)
    except ArithBuildError:
        spec = build_arith_prefix_spec(codec, dtype=np.float32)
    dec = ArithLUTDecoder(codec, device, early_exit=True, spec=spec)
    if dec.loop != "qc":
        raise ValueError(f"the fused harness runs the QC passes; this codec takes the "
                         f"{dec.loop} loop")
    return dec


def fused_inputs(dec, B: int, seed: int = 0):
    """(messages (rows_vn, B), channel values (nvar_pad, B)) in the decoder's
    dtype, integers in [-2000, 2000) from np.random.default_rng(seed), as
    the JAX tool draws them."""
    import torch

    rng = np.random.default_rng(seed)
    dt = np.dtype(dec.spec.dtype)
    mv = rng.integers(-2000, 2000, (dec.tables.rows_vn, B)).astype(dt)
    cha = rng.integers(-2000, 2000, (dec.tables.nvar_pad, B)).astype(dt)
    return torch.as_tensor(mv, device=dec.device), torch.as_tensor(cha, device=dec.device)


def fused_chain(dec, m, cha, scan_len: int, plain: bool = False):
    """scan_len iterations of cn_qc_pass -> vn_qc_pass on iteration 0's
    parameters, each pass's output the next one's input; returns the last
    VN output.  plain: the passes' plain versions (cn_qc_pass_ref ->
    vn_qc_pass_ref) on any device, to hold the kernels against."""
    from ..decoder import qc_kernels as qk

    cn, vn = ((qk.cn_qc_pass_ref, qk.vn_qc_pass_ref) if plain else
              (qk.cn_qc_pass, qk.vn_qc_pass))
    for _ in range(scan_len):
        m_cn, _ = cn(m, dec.tables)
        m, _, _ = vn(m_cn, cha, 0, dec.params, dec.tables)
    return m


def fused_ms(codec, B: int, device, scan_len: int = 16) -> float:
    """Fused CN + VN ms an iteration on the card."""
    dec = fused_decoder(codec, device)
    m, cha = fused_inputs(dec, B)
    return _timeit(lambda: fused_chain(dec, m, cha, scan_len), device) * 1e3 / scan_len


def labels(codec, B: int, snr_db: float, rng):
    """B frames of the all-zero codeword over BI-AWGN at snr_db, drawn from
    rng as the JAX tool draws them: (channel labels, message labels)."""
    from ..ops.pmf import snr2sig

    sig = float(snr2sig(0.5, snr_db))
    y = 1.0 + sig * rng.standard_normal((B, codec.nvar))
    return codec.quantize_channel(2.0 * y / sig**2)


def _on(device, lc, lm):
    import torch

    return (torch.as_tensor(np.asarray(lc, np.int32), device=device),
            torch.as_tensor(np.asarray(lm, np.int32), device=device))


def headline(codec, device, rng) -> dict:
    """compile_s (host clock over building a make_staged_decoder with its
    generated VN units compiled cold into a temporary directory, and its
    first two calls), the units it compiled, and headline_decode_ms (the
    minimum of 5), B=8192, 2 dB."""
    import torch

    from ..decoder import make_staged_decoder, vn_codegen

    lc, lm = _on(device, *labels(codec, 8192, 2.0, rng))
    torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as d, vn_codegen.cold_units(d) as units:
        t0 = time.perf_counter()
        dec = make_staged_decoder(codec, device, early_exit=True)
        dec(lc, lm)
        dec(lc, lm)
        torch.cuda.synchronize(device)
        compile_s = time.perf_counter() - t0
        unit_s = sorted(lib.seconds for lib in units.values())
        ms = _timeit(lambda: dec(lc, lm), device, reps=5) * 1e3
    return {"compile_s": compile_s, "compile_vn_units": len(unit_s),
            "compile_units_s": unit_s, "headline_decode_ms": ms}


def decode_ms(codec, device, rng) -> float:
    """ArithLUTDecoder ms a call at B=1024, 1.6 dB."""
    from ..decoder import ArithLUTDecoder

    dec = ArithLUTDecoder(codec, device, early_exit=True)
    lc, lm = _on(device, *labels(codec, 1024, 1.6, rng))
    return _timeit(lambda: dec(lc, lm), device) * 1e3


def build_s() -> tuple:
    """(wall seconds, {unit: seconds}) of the kernel library's units compiled
    cold, side by side, into a temporary directory (the loaded libraries in
    build/torch_kernels/ are left alone)."""
    from ..decoder import nvcc, qc_kernels as qk

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        builds = {unit: nvcc.Build(os.path.join(d, f"lib{unit}.so"),
                                   os.path.join(nvcc.CSRC_DIR, source), flags, force=True)
                  for unit, (source, _, flags) in qk.UNITS.items()}
        for b in builds.values():
            b.wait()
        return time.perf_counter() - t0, {u: b.seconds for u, b in builds.items()}


def design_codecs(codecs=None) -> dict:
    """The four codecs the metrics decode, designed where `codecs` lacks
    them: "headline" (sigma 0.85), "n64800_qc", "dvbs2" and "peg" (0.90);
    all q4 min-LUT with 50 iterations."""
    from .. import bench, bench_n64800 as b64

    codecs = dict(codecs or {})
    builders = {"headline": bench.build_codec, "n64800_qc": lambda: b64.build_codec("qc"),
                "dvbs2": lambda: b64.build_codec("dvbs2"),
                "peg": lambda: b64.build_codec("peg")}
    for name, build in builders.items():
        if name not in codecs:
            codecs[name] = build()
    return codecs


def record(device="cuda", codecs=None) -> dict:
    """One ledger entry measured on `device`, a CUDA device.  codecs: the
    already-designed codecs of design_codecs by name (the rest are designed
    here)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"perf_regress records card times only, not on {dev}")
    codecs = design_codecs(codecs)
    entry = {"rev": _rev(), "ts": time.time(), "device": device_info()}
    entry["n10000_fused_ms"] = fused_ms(codecs["headline"], 8192, dev)
    entry["n64800_fused_ms"] = fused_ms(codecs["n64800_qc"], 1024, dev, scan_len=8)
    rng = np.random.default_rng(0)
    entry.update(headline(codecs["headline"], dev, rng))
    entry["dvbs2_decode_ms"] = decode_ms(codecs["dvbs2"], dev, rng)
    entry["peg_decode_ms"] = decode_ms(codecs["peg"], dev, rng)
    entry["build_s"], entry["build_units_s"] = build_s()
    return entry


def append(entry: dict, ledger: str | None = None) -> None:
    ledger = ledger or LEDGER
    hist = []
    if os.path.exists(ledger):
        with open(ledger) as f:
            hist = json.load(f)
    hist.append(entry)
    os.makedirs(os.path.dirname(os.path.abspath(ledger)), exist_ok=True)
    with open(ledger, "w") as f:
        json.dump(hist, f, indent=1)


def _card(entry: dict) -> tuple:
    """(name, power limit) of the card an entry was measured on: a record
    of another card, or of this one held to another power limit, is no
    baseline."""
    dev = entry.get("device") or {}
    return dev.get("name"), dev.get("power_limit")


def check(tol: float, ledger: str | None = None) -> int:
    """The newest entry against the last three earlier entries of the same
    card at the same power limit; 1 on a regression or without a ledger,
    else 0."""
    ledger = ledger or LEDGER
    if not os.path.exists(ledger):
        print("perf_regress: no ledger yet — run `record` first")
        return 1
    with open(ledger) as f:
        hist = json.load(f)
    if len(hist) < 2:
        print("perf_regress: single record, nothing to compare")
        return 0
    cur, card = hist[-1], _card(hist[-1])
    same = []
    for rec in hist[:-1]:
        if _card(rec) == card:
            same.append(rec)
        else:
            print(f"skipped record {rec.get('rev')} of {rec.get('ts')}: card "
                  f"{', '.join(map(str, _card(rec)))}, newest on {', '.join(map(str, card))}")
    prev = same[-3:]
    rc = 0
    for m in METRICS:
        vals = [p[m] for p in prev if m in p]
        now = cur.get(m)
        if not vals:
            print(f"{m:22s} no prior records — skipped")
            continue
        # compile times: the best of the prior records is the warmest
        # outlier; the median keeps one warm run from flagging every later
        # cold one
        best = statistics.median(vals) if m in COMPILE_METRICS else min(vals)
        if now is None:
            continue
        m_tol = COMPILE_TOL if m in COMPILE_METRICS else tol
        decay = now / best - 1.0
        flag = "REGRESSION" if decay > m_tol else "ok"
        if decay > m_tol:
            rc = 1
        print(f"{m:22s} {now:9.3f} vs best-of-3 {best:9.3f} "
              f"({decay:+.1%}) {flag}")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["record", "check"])
    ap.add_argument("--tol", type=float, default=0.12,
                    help="decay tolerance of the gated decode times (the JAX "
                         "tool's default)")
    ap.add_argument("--ledger", default=None,
                    help="the ledger file (default docs/perf/kernels_torch.json)")
    ap.add_argument("--device", default="cuda", help="the CUDA device to record on")
    args = ap.parse_args(argv)
    if args.mode == "check":
        return check(args.tol, args.ledger)
    import torch

    if not torch.cuda.is_available() or torch.device(args.device).type != "cuda":
        print("perf_regress: no CUDA device — refusing to record misleading CPU timings")
        return 1
    entry = record(args.device)
    append(entry, args.ledger)
    print(json.dumps(entry))
    return 0


if __name__ == "__main__":
    sys.exit(main())
