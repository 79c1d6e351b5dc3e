"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints; any failure raises and exits non-zero):
 1. the card (nvidia-smi name and power limit), torch and CUDA versions;
 2. build the CUDA kernels from lut_ldpc_torch/csrc/ and print what ptxas
    reports for each; design the N=64800 PEG codec;
 3. the QC kernels against their plain-torch twins on the card at the
    headline shapes (N=10000 (3,6) QC code, Z=1000, B=8192), in the int16
    and the float32 spec: values, bits, syndrome and unanimity must be equal;
 4. the headline decode through make_staged_decoder (a HybridLUTDecoder
    with a 32-iteration int16 prefix) at 2 dB, with launch counts, checked
    against the twin path on the card and the scalar golden model;
 5. a 1.5 dB batch that leaves frames undecided past the prefix, so the
    table tail runs on the card, checked the same way;
 6. the headline throughput (decoded information Mbit/s, B=8192, not cut)
    and one traced decode (device busy time, torch glue, idle share);
 7. the std-layout kernels against their twins at the PEG N=64800 shapes
    (280277 edges, B=4096), int16 and float32 spec, a middle iteration;
    meanwhile two worker processes take the codec's GF(2) rank and one
    golden-model frame (minutes of host time at this size);
 8. the PEG decode through make_staged_decoder at 1.6 dB, B=4096 (a
    MixedArithDecoder: int16 kernels, then float32 kernels for the frames
    still undecided), with launch counts per kernel and dtype, checked
    against the twin path on the card for the 512 slowest frames and
    against the golden model for one frame;
 9. the PEG throughput (decoded information Mbit/s).
Then a JSON line of per-kernel results (time, plain twin's time, the
card's bound for the same work), the card, and last the device line.
"""

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores, same sheet
CN_OPS_PER_EDGE = 13       # two-min + parity in, select + sign out

SOURCE = "lut_ldpc_torch/csrc/qc_kernels.cu"
REPLACES = {"cn_qc_pass": "lut_ldpc_tpu/decoder/qc_kernels.py:549",
            "vn_qc_pass": "lut_ldpc_tpu/decoder/qc_kernels.py:873",
            "cn_std_pass": "lut_ldpc_tpu/decoder/qc_kernels.py:1206",
            "vn_std_pass": "lut_ldpc_tpu/decoder/qc_kernels.py:1353"}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_summary(text):
    """Per kernel instantiation "name<type, MAXD>: registers, stack bytes,
    spill bytes" from the build's ptxas -v report."""
    import re

    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"((?:cn|vn)_(?:qc|std)_kernel)I([sf])Li(\d+)E", line)
        if m and "Compiling entry function" in line:
            name = f"{m.group(1)}<{'int16' if m.group(2) == 's' else 'float'}, {m.group(3)}>"
            stack = spill = "?"
        elif name and "stack frame" in line:
            stack = re.search(r"(\d+) bytes stack frame", line).group(1)
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {stack} B stack, {spill} B spill stores")
            name = None
    return out


def straddled(op, d):
    """Inner outputs i (0 < i < d - 1) whose leave-one-out evaluation must
    redo `op`: its message span (lo, hi) has lo < i <= hi."""
    lo, hi = op.span
    return 0 if lo < 0 else sum(lo < i <= hi for i in range(1, d - 1))


def vn_ops_per_frame(params, blocks):
    """Float32 operations of one VN pass for one frame by the cheapest
    evaluation known, the one `vn_update` does: per real node two sweeps of
    the class tree (identity and shift-by-one leaves), then for each inner
    output only the ops whose message span straddles it, and one sign
    compare per output.  An op costs its operand adds, a compare and a
    select per threshold, three more for a symmetric chain and three for a
    tie."""
    total = 0
    for cls, blk in zip(params.classes, blocks):
        d = cls.degree
        node = d  # sign compares
        for op in cls.ops:
            cost = len(op.operands) - 1 + 2 * op.nthr + 3 * op.sym + 3 * op.has_tie
            node += (2 + straddled(op, d)) * cost
        total += blk.num_nodes * node
    return total


def bounds(dec, B):
    """Per pass the least time the card could take: the larger of bytes moved
    (every real message row read once and written once, channel values read,
    bits written) over the memory rate and float32 operations over the
    float32 rate.  Returns {"cn": (ms, by), "vn": (ms, by)}."""
    lay = dec.layout
    size = dec.dtype.itemsize
    E, nvar = lay.num_edges, lay.nvar
    out = {}
    for key, nbytes, ops in (
            ("cn", 2 * E * B * size + B, CN_OPS_PER_EDGE * E * B),
            ("vn", (2 * E + nvar) * B * size + nvar * B + B,
             vn_ops_per_frame(dec.params, lay.vn_blocks) * B)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        out[key] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
    return out


def kernel_vs_twin(dec, it, seed, B):
    """CN then VN kernel of `dec`'s path (QC or std) against its twin on one
    (rows, B) input; returns {kernel name: (max_abs_err, kernel ms, twin ms)}."""
    import numpy as np
    import torch

    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.decoder.hybrid import root_levels

    tab, prm, spec = dec.tables, dec.params, dec.spec
    dev = dec.device
    qc = dec.plan is not None
    cn, cn_ref = (qk.cn_qc_pass, qk.cn_qc_pass_ref) if qc else (qk.cn_std_pass, qk.cn_std_pass_ref)
    vn, vn_ref = (qk.vn_qc_pass, qk.vn_qc_pass_ref) if qc else (qk.vn_std_pass, qk.vn_std_pass_ref)
    cn_name, vn_name = ("cn_qc_pass", "vn_qc_pass") if qc else ("cn_std_pass", "vn_std_pass")
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(root_levels(spec, it), device=dev).to(dec.dtype)

    def values(rows):
        return table[torch.as_tensor(rng.integers(0, len(table), (rows, B)), device=dev)]

    # the QC CN kernel reads the VN-grouped array, the std one the CN-grouped
    m_in = values(tab.rows_vn if qc else tab.rows_cn)
    cha_t = torch.as_tensor(np.asarray(spec.leaf_cha), device=dev).to(dec.dtype)
    cha = cha_t[torch.as_tensor(rng.integers(0, len(cha_t), (tab.nvar_pad, B)), device=dev)]
    real_cn, real_vn, nodes = tab.cn_real, tab.vn_real, tab.node_real

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    out = {}
    m_cn_k, synd_k = cn(m_in, tab)
    m_cn_t, synd_t = cn_ref(m_in, tab)
    torch.cuda.synchronize()
    e = err(m_cn_k[real_cn], m_cn_t[real_cn])
    if e != 0 or not torch.equal(synd_k, synd_t):
        raise AssertionError(f"{cn_name} disagrees with its twin (max err {e})")
    out[cn_name] = (e, cuda_ms(lambda: cn(m_in, tab), 20),
                    cuda_ms(lambda: cn_ref(m_in, tab), 3))
    del m_cn_k
    # the QC VN kernel reads the CN-grouped array, the std one the VN-grouped
    m_c2v = m_cn_t if qc else values(tab.rows_vn)
    del m_in, m_cn_t
    m_vn_k, bits_k, unan_k = vn(m_c2v, cha, it, prm, tab)
    m_vn_t, bits_t, unan_t = vn_ref(m_c2v, cha, it, prm, tab)
    torch.cuda.synchronize()
    e = err(m_vn_k[real_vn], m_vn_t[real_vn])
    if (e != 0 or not torch.equal(bits_k[nodes], bits_t[nodes])
            or not torch.equal(unan_k, unan_t)):
        raise AssertionError(f"{vn_name} disagrees with its twin (max err {e})")
    del m_vn_k, m_vn_t
    out[vn_name] = (e, cuda_ms(lambda: vn(m_c2v, cha, it, prm, tab), 20 if qc else 5),
                    cuda_ms(lambda: vn_ref(m_c2v, cha, it, prm, tab), 3 if qc else 1))
    log(f"#   synd true {int(synd_k.sum())}/{B}, unan true {int(unan_k.sum())}/{B}")
    return out


def kernels_both_specs(codec, dev, B, phase, results):
    """Phase 3 / 7: both kernels of the codec's path against their twins in
    the int16 and the float32 prefix spec; fills `results` per kernel."""
    import numpy as np

    from lut_ldpc_torch.decoder import ArithLUTDecoder, build_arith_prefix_spec

    for dt in (np.int16, np.float32):
        spec = build_arith_prefix_spec(codec, dtype=dt)
        dec = ArithLUTDecoder(codec, dev, spec=spec)
        it = spec.num_iters // 2
        res = kernel_vs_twin(dec, it, seed=1, B=B)
        bnd = bounds(dec, B)
        if dt == np.int16:
            evals = {c.degree: sum(2 + straddled(op, c.degree) for op in c.ops)
                     for c in dec.params.classes}
            log(f"# phase {phase}: VN op evaluations per node and frame by degree "
                f"(full leave-one-out: d x ops): "
                + ", ".join(f"d={d}: {n} ({d * len(c.ops)})"
                            for (d, n), c in zip(evals.items(), dec.params.classes))
                + f"; {vn_ops_per_frame(dec.params, dec.layout.vn_blocks)} float32 "
                f"operations a frame")
        for name, (e, ms, plain) in res.items():
            b_ms, b_by = bnd[name[:2]]
            log(f"# phase {phase}: {name} {np.dtype(dt).name} it={it}: equal to twin; "
                f"kernel {ms:.4f} ms, twin {plain:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
            if dt == np.int16:
                results[name] = dict(max_abs_err=e, ms=ms, plain_ms=plain,
                                     bound_ms=b_ms, bound_by=b_by, library_ms=None)
            else:
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
        del dec


def check_golden(codec, lc, lm, out, frames):
    import numpy as np

    bits, _, iters = (o.cpu().numpy() for o in out)
    for f in frames:
        t0 = time.perf_counter()
        b_ref, it_ref = codec.decode_ref(lc[f], lm[f])
        itr = it_ref if it_ref > 0 else codec.max_iters
        if not np.array_equal(np.asarray(b_ref), bits[f]) or itr != iters[f]:
            raise AssertionError(f"frame {f} differs from decode_ref")
        log(f"#   frame {f}: decode_ref agrees (iters {itr}, "
            f"{time.perf_counter() - t0:.1f}s)")


def same(a, b, what):
    import torch

    for x, y, name in zip(a, b, ("bits", "ok", "iters")):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differ")


def check_shapes(out, B, nvar):
    bits, ok, iters = out
    if bits.shape != (B, nvar) or ok.shape != (B,) or iters.shape != (B,):
        raise AssertionError("unexpected output shapes")


def headline(dev, smi, results, launches):
    """Phases 3-6: the N=10000 QC headline of lut_ldpc_torch.bench."""
    import numpy as np
    import torch

    from lut_ldpc_torch import bench
    from lut_ldpc_torch.decoder import HybridLUTDecoder, make_staged_decoder
    from lut_ldpc_torch.decoder import qc_kernels as qk

    t0 = time.perf_counter()
    codec = bench.build_codec()
    log(f"# headline codec designed in {time.perf_counter() - t0:.1f}s (N={codec.nvar}, "
        f"k={codec.k}, {codec.max_iters} iterations)")
    B = bench.BATCH
    kernels_both_specs(codec, dev, B, 3, results)

    lc, lm = bench.channel_labels(codec, B, 2.0)
    lc_d, lm_d = torch.as_tensor(lc, device=dev), torch.as_tensor(lm, device=dev)
    dec = make_staged_decoder(codec, dev)
    if not isinstance(dec, HybridLUTDecoder) or dec.S != 32:
        raise AssertionError(f"expected HybridLUTDecoder with S=32, got {type(dec).__name__}")
    qk.reset_launches()
    out = dec(lc_d, lm_d)
    torch.cuda.synchronize()
    for name in ("cn_qc_pass", "vn_qc_pass"):
        launches[name] = qk.LAUNCHES[name]
        if launches[name] < 1:
            raise AssertionError(f"headline path skipped {name}")
    check_shapes(out, B, codec.nvar)
    _, ok, iters = out
    log(f"# phase 4: {type(dec).__name__} S={dec.S}: launches {dict(qk.LAUNCHES)}, "
        f"ok {float(ok.float().mean()):.6f}, mean iters {float(iters.float().mean()):.4f}, "
        f"tail runs {dec.tail_runs}")
    twin = HybridLUTDecoder(codec, dev, kernels=False)
    same(out, twin(lc_d, lm_d), "2 dB kernel path vs twin path")
    log("#   twin path on the card: identical bits, ok, iters")
    check_golden(codec, lc, lm, out, [0, int(torch.argmax(iters).item())])

    lc15, lm15 = bench.channel_labels(codec, B, 1.5, seed=1)
    lc15_d, lm15_d = torch.as_tensor(lc15, device=dev), torch.as_tensor(lm15, device=dev)
    runs = dec.tail_runs
    out15 = dec(lc15_d, lm15_d)
    it15 = out15[2].cpu().numpy()
    late = np.nonzero(it15 >= dec.S)[0]
    if dec.tail_runs != runs + 1 or late.size == 0:
        raise AssertionError("the 1.5 dB batch did not reach the table tail")
    same(out15, twin(lc15_d, lm15_d), "1.5 dB kernel path vs twin path")
    conv_late = late[it15[late] < codec.max_iters]
    pick = int(conv_late[0]) if conv_late.size else int(late[0])
    log(f"# phase 5: 1.5 dB: {late.size} frames past iteration {dec.S}, ok "
        f"{float(out15[1].float().mean()):.6f}; twin path identical")
    check_golden(codec, lc15, lm15, out15, [pick])

    dt_s, out = bench.time_decode(dec, lc_d, lm_d, bench.REPS)
    mbits = B * codec.k / dt_s / 1e6
    log(f"# phase 6: headline {mbits:.3f} Mbit/s ({dt_s * 1e3:.3f} ms per {B} frames, "
        f"mean iters {float(out[2].float().mean()):.4f}, ok {float(out[1].float().mean()):.6f}) "
        f"on {smi}")
    # the throughput is on the host's clock: one traced decode shows how
    # much of it the card was busy, and with what
    from torch.profiler import ProfilerActivity, profile

    from lut_ldpc_torch.profile_decode import device_breakdown

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec(lc_d, lm_d)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, busy, span = device_breakdown(prof)
    if busy == 0.0:
        raise AssertionError("the profiler recorded no device time")
    kern = sum(ms for name, _, ms in rows if "_qc_kernel" in name)
    log(f"#   traced decode: wall {wall:.3f} ms, device span {span:.3f} ms, busy "
        f"{busy:.3f} ms (CN+VN kernels {kern:.3f}, torch glue {busy - kern:.3f}), "
        f"idle {100 * (1 - busy / span):.1f} % of the span")


def peg(dev, smi, codec, lc, lm, golden, rank, results, launches):
    """Phases 7-9: the N=64800 PEG code of lut_ldpc_torch.bench_n64800."""
    import numpy as np
    import torch

    from lut_ldpc_torch import bench, bench_n64800 as b64
    from lut_ldpc_torch.decoder import MixedArithDecoder, make_staged_decoder
    from lut_ldpc_torch.decoder import qc_kernels as qk

    B = b64.BATCH
    kernels_both_specs(codec, dev, B, 7, results)
    torch.cuda.empty_cache()

    lc_d, lm_d = torch.as_tensor(lc, device=dev), torch.as_tensor(lm, device=dev)
    t0 = time.perf_counter()
    dec = make_staged_decoder(codec, dev, max_batch=B)
    inner = getattr(dec, "inner", dec)
    if not isinstance(inner, MixedArithDecoder) or inner.pre.plan is not None:
        raise AssertionError(f"expected MixedArithDecoder on the std path, got "
                             f"{type(dec).__name__}/{type(inner).__name__}")
    log(f"#   {type(dec).__name__} (inner {type(inner).__name__}, S16={inner.S16}, "
        f"S={inner.S}) built in {time.perf_counter() - t0:.1f}s")
    qk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = dec(lc_d, lm_d)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    by_dtype = {f"{n}/{dt}": c for (n, dt), c in qk.LAUNCHES_BY_DTYPE.items() if c}
    for name in ("cn_std_pass", "vn_std_pass"):
        launches[name] = qk.LAUNCHES[name]
        for dt in ("int16", "float32"):
            if qk.LAUNCHES_BY_DTYPE[name, dt] < 1:
                raise AssertionError(f"PEG path launched no {name} in {dt}: {by_dtype}")
    check_shapes(out, B, codec.nvar)
    _, ok, iters = out
    past = int((iters > inner.S16).sum())
    if inner.fin_runs != 1 or past < 1:
        raise AssertionError("no frame was undecided after the int16 segment")
    log(f"# phase 8: launches {by_dtype}; ok {float(ok.float().mean()):.6f}, mean iters "
        f"{float(iters.float().mean()):.4f}, {past} frames past iteration {inner.S16}, "
        f"peak device memory {peak:.2f} GiB")
    # the 512 slowest frames (every frame of the float32 segment among them)
    # through the twin path, against the same frames of the full batch
    idx = torch.argsort(iters, descending=True, stable=True)[:512]
    twin = MixedArithDecoder(codec, dev, kernels=False)
    t0 = time.perf_counter()
    out_t = twin(lc_d[idx], lm_d[idx])
    torch.cuda.synchronize()
    same([o[idx] for o in out], out_t, "PEG kernel path vs twin path")
    if twin.fin_runs != 1:
        raise AssertionError("the twin path's float32 segment did not run")
    log(f"#   twin path on the card, 512 slowest frames: identical bits, ok, iters "
        f"({time.perf_counter() - t0:.1f}s)")
    del twin, out_t
    b_ref, it_ref, secs = golden.get()
    itr = it_ref if it_ref > 0 else codec.max_iters
    if (not np.array_equal(np.asarray(b_ref), out[0][0].cpu().numpy())
            or itr != int(iters[0])):
        raise AssertionError("PEG frame 0 differs from decode_ref")
    log(f"#   frame 0: decode_ref agrees (iters {itr}, {secs:.1f}s in a worker process)")

    k, secs = rank.get()
    log(f"#   k={k} (GF(2) rank in {secs:.1f}s in a worker process)")
    dt_s, out = bench.time_decode(dec, lc_d, lm_d, 3)
    mbits = B * k / dt_s / 1e6
    log(f"# phase 9: PEG N=64800 {mbits:.3f} Mbit/s ({dt_s * 1e3:.3f} ms per {B} frames, "
        f"mean iters {float(out[2].float().mean()):.4f}, ok {float(out[1].float().mean()):.6f}) "
        f"on {smi}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"# phase 1: card {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    import multiprocessing
    import os

    from lut_ldpc_torch import bench, bench_n64800 as b64
    from lut_ldpc_torch.decoder import qc_kernels as qk

    dev = torch.device("cuda")
    _, secs, report = qk.build_kernels(force=True)
    log(f"# phase 2: built {qk.KERNEL_SOURCE} in {secs:.1f}s")
    for line in ptxas_summary(report):
        log(f"#   ptxas {line}")
    os.environ.setdefault("LUT_DECODE_MEM_BUDGET", str(b64.MEM_BUDGET))

    t0 = time.perf_counter()
    codec = b64.build_codec("peg")
    log(f"#   PEG codec designed in {time.perf_counter() - t0:.1f}s (N={codec.nvar}, "
        f"{codec.graph.num_edges} edges, {codec.max_iters} iterations)")
    lc, lm = bench.channel_labels(codec, b64.BATCH, b64.SNR_DB)
    results, launches = {}, {}
    headline(dev, smi, results, launches)
    torch.cuda.empty_cache()
    # the workers start after the headline's timed phase (they load the
    # host) and are done before the PEG one; leaving the block terminates
    # them, also after a failure
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        rank = pool.apply_async(b64.info_bits, ("peg",))
        golden = pool.apply_async(b64.golden_frame, ("peg", lc[0], lm[0]))
        peg(dev, smi, codec, lc, lm, golden, rank, results, launches)

    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=SOURCE, replaces=REPLACES[n],
             launches=launches[n], **results[n]) for n in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
