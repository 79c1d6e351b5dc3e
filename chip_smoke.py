"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints; any failure raises and exits non-zero):
 1. the card (nvidia-smi name and power limit), torch and CUDA versions;
 2. design the headline, the N=64800 PEG and the two DVB-S2 codecs, and
    meanwhile build every CUDA library side by side, one nvcc each: the
    kernel library's three units (the CN frames of csrc/cn_frames.cuh for
    int16 and for float32 messages, and csrc/qc_kernels.cu: the CN block
    kernel and the table-driven witnesses), one generated VN unit per
    arithmetic spec and loop (lut_ldpc_torch/decoder/vn_codegen.py in the
    frames of csrc/vn_frames.cuh: the QC and std class kernels, and the
    block kernels of the headline and PEG block loops); print the build
    seconds and what ptxas reports for each kernel; the CN frames that the
    QC N=64800 decode would launch (check degrees 8 and 9) must have no
    stack frame and no spill, as those of every decode below, and so must
    every generated block kernel;
 3. the QC kernels at the headline shapes (N=10000 (3,6) QC code, Z=1000,
    B=8192), in the int16 and the float32 spec: the CN frames and the
    generated VN kernel each against its table-driven witness and its plain
    version, at B and at the odd width B - 3 (values on real rows, bits,
    syndrome and unanimity equal; the CN input's padding rows hold random
    values, the VN input's whatever the CN plain version left there), with
    their times, ptxas registers of the CN instantiations that ran (no stack,
    no spill allowed); the VN kernel must be the faster of its two;
 4. the headline decode through make_staged_decoder (a HybridLUTDecoder
    with a 32-iteration int16 prefix) at 2 dB, with launch counts, checked
    against the twin path on the card and the scalar golden model;
 5. a 1.5 dB batch that leaves frames undecided past the prefix, so the
    table tail runs on the card, checked the same way;
 6. the headline throughput (decoded information Mbit/s, B=8192, not cut)
    and one traced decode (device busy time, torch glue, idle share);
    then the PEG codec's GF(2) rank starts in a worker process; two more
    workers, started in phase 2 as soon as the labels exist, run one
    golden-model frame each of the PEG and the DVB-S2 code (minutes of host
    time at this size), read at the end;
 7. the std-layout kernels at the PEG N=64800 shapes (280277 edges, B=4096
    and 4093), int16 and float32 spec, a middle iteration, as in phase 3;
    the CN frames read and write the VN-grouped arrays (the row gathers
    folded in), and the unfolded route (two index_select + the CN frames on
    the CN-grouped planes) is timed beside them;
 8. the PEG decode through make_staged_decoder at 1.6 dB, B=4096 (a
    MixedArithDecoder: int16 kernels, then float32 kernels for the frames
    still undecided), with launch counts per kernel and dtype, checked
    against the twin path on the card for the 512 slowest frames;
 9. the PEG throughput (decoded information Mbit/s);
10. the per-degree-block kernels at the lut_ldpc_torch.profile_kernels
    shapes (headline codec, d=6 x 5000 checks, d=3 x 10000 variables,
    B=4096 and 4093) in both dtypes: the CN block kernel against its plain
    version, the generated VN block kernel against its plain version, the
    table-driven witness and the generated std class kernel on the same
    planes, with single-call and chained times; the same on every degree
    block of the PEG codec (variable degrees 2, 3, 9, 17; check degrees 8,
    9, 10) at B=4096 (the plain versions timed once);
11. the block-loop decode of the headline batch (loop="blocks", the full
    int16 prefix, B=8192): bits, ok and iters equal to the QC-kernel decode,
    with its launch counts and time; then the PEG N=64800 int16 prefix on the
    block loop at B=4096, 1.6 dB, equal to the same prefix on the std loop,
    with its time;
12. a small phantom-completed graph whose phantom node has true degree 2
    (only the block loop decodes it) on the generated block kernels,
    against the golden model;
13. the DVB-S2 standard matrix (Z=360 form, one phantom edge) through
    make_staged_decoder at 1.6 dB, B=4096: the float32 CN frames and
    generated VN kernel at these shapes as in phase 3, class, launches by
    dtype, peak memory,
    the first 256 frames against the twin path on the card, and the
    throughput (3 calls after 2 warm-ups);
14. the same matrix unpermuted (a degree-1 variable, no phantom) on the
    std kernels, 512 of the same frames carried through the column
    permutation: same ok and iters, same bits after un-permuting;
15. the golden-model frames of the PEG and the DVB-S2 decode from the
    workers.
Every main-path decode (phases 4, 8, 11, 13, 14) must have run each CN and
VN pass on the CN frames, the CN block kernel or the generated VN kernels,
none on a table-driven witness.  Then a JSON line of per-kernel results
(time, plain twin's time, the card's bound for the same work; `launches`
counts the wrapper's calls on the main path (one a pass; one a degree block
for `cn_block_pass`), `class_launches` the kernel launches these made, one
a degree class, block or run of block-rows; the rows of the CN frames and
of the generated VN kernels also carry `witness_ms`, the table-driven
kernel's time, and `cn_std_pass` `unfolded_ms`), the card, and last the
device line.
"""

import json
import subprocess
import sys
import time

SOURCE = "lut_ldpc_torch/csrc/qc_kernels.cu"  # CN block kernel, table-driven witnesses
CN_SOURCE = "lut_ldpc_torch/csrc/cn_frames.cuh"  # built through csrc/cn_frames.cu
VN_SOURCE = "lut_ldpc_torch/csrc/vn_frames.cuh"  # frames of the generated units
SOURCES = {"cn_qc_pass": CN_SOURCE, "cn_std_pass": CN_SOURCE,
           "vn_qc_pass": VN_SOURCE, "vn_std_pass": VN_SOURCE,
           "cn_block_pass": SOURCE, "vn_block_pass": VN_SOURCE}
REPLACES = {"cn_qc_pass": "lut_ldpc_tpu/decoder/qc_kernels.py:549",
            "vn_qc_pass": "lut_ldpc_tpu/decoder/qc_kernels.py:873",
            "cn_std_pass": "lut_ldpc_tpu/decoder/qc_kernels.py:1206",
            "vn_std_pass": "lut_ldpc_tpu/decoder/qc_kernels.py:1353",
            "cn_block_pass": "lut_ldpc_tpu/decoder/pallas_kernels.py:115",
            "vn_block_pass": "lut_ldpc_tpu/decoder/pallas_kernels.py:227"}


T_START = time.perf_counter()
BUILD_REPORT = []  # ptxas -v report of the two CN frame units, set in phase 2


def log(msg):
    """One line of the run's log, with the seconds since the script began."""
    print(f"{msg} [{time.perf_counter() - T_START:.0f}s]", flush=True)


def ptxas_summary(text):
    """Per table-driven or block kernel instantiation "name<type, MAXD>:
    registers, stack bytes, spill bytes" from the build's ptxas -v report."""
    from lut_ldpc_torch.decoder.nvcc import ptxas_entries

    return [f"{k}<{'int16' if t == 's' else 'float'}, {w}>: {r['registers']} registers, "
            f"{r['stack']} B stack, {r['spill_stores']} B spill stores"
            for r in ptxas_entries(text, r"((?:cn|vn)_(?:qc|std|block)_kernel)I([sf])Li(\d+)E")
            for k, t, w in [r["groups"]]]


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
    float32 rate (the data-sheet rates of lut_ldpc_torch.profile_kernels).
    Returns {"cn": (ms, by), "vn": (ms, by)}."""
    from lut_ldpc_torch import profile_cn as pc, profile_kernels as pk

    lay = dec.layout
    size = dec.dtype.itemsize
    E, nvar = lay.num_edges, lay.nvar
    return {"cn": pc.cn_bound(dec, B),
            "vn": pk.bound_ms((2 * E + nvar) * B * size + nvar * B + B,
                              vn_ops_per_frame(dec.params, lay.vn_blocks) * B)}


def unit_summary(dec, B):
    """Of the generated unit `dec` launches at B frames: per class the
    instantiation that runs (frames a thread), its registers, stack and
    spill bytes from ptxas, and the unit's build seconds."""
    from lut_ldpc_torch.decoder.vn_codegen import library, ptxas_by_kernel

    lib = library(dec.params, dec.dtype, dec.loop)
    vec = lib.handle().lut_vn_vec
    rows = {(r["cls"], r["vec"]): r for r in ptxas_by_kernel(lib.report)}
    parts = []
    for c, cls in enumerate(dec.params.classes[: dec.params.kernel_classes]):
        r = rows.get((c, vec(c, B, 1)))
        parts.append(f"d={cls.degree} x{vec(c, B, 1)}: " + (
            f"{r['registers']} regs, {r['stack']} B stack, "
            f"{r['spill_stores'] + r['spill_loads']} B spills" if r else "not rebuilt"))
    return "classes " + "; ".join(parts) + f"; unit built in {lib.seconds:.1f}s"


def vn_check(dec, it, m_c2v, cha, what, reps, plain_reps):
    """The generated VN kernel of `dec` at iteration `it` on (m_c2v, cha) and
    on the same input cut to an odd width (3 frames fewer: one frame a
    thread, unaligned rows): equal to the table-driven kernel and to the
    plain version (lut_ldpc_torch.profile_vn.check_vn raises otherwise), and
    faster than the table-driven kernel.  Logs one line per width; returns
    the full-width result."""
    from lut_ldpc_torch import profile_vn as pv

    B = m_c2v.shape[1]
    bnd = bounds(dec, B)["vn"]
    full = None
    for width in (B, B - 3):
        if width == B:
            r = pv.check_vn(dec, it, m_c2v, cha, reps=reps, plain_reps=plain_reps)
        else:
            r = pv.check_vn(dec, it, m_c2v[:, :width].contiguous(),
                            cha[:, :width].contiguous(), reps=max(2, reps // 4))
        if r["ms"] >= r["generic_ms"]:
            raise AssertionError(f"{what}: generated {r['name']} ({r['ms']:.3f} ms) is not "
                                 f"faster than the table-driven kernel "
                                 f"({r['generic_ms']:.3f} ms) at B={width}")
        log(f"# {what} B={width}: generated {r['name']} equal to the table-driven kernel "
            f"and the plain version; generated {r['ms']:.4f} ms, table-driven "
            f"{r['generic_ms']:.4f} ms"
            + (f", plain {r['plain_ms']:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
               if width == B else "") + "; " + unit_summary(dec, width))
        full = full or r
    return full


def cn_check(dec, it, B, what, reps, plain_reps, seed=1):
    """The CN frames of `dec` on iteration `it`'s values (random table
    entries in every VN-grouped row, padding rows included, every 16th frame
    positive) and on the same input cut to an odd width (3 frames fewer: one
    frame a thread, unaligned rows): equal to the table-driven kernel and the
    plain version (lut_ldpc_torch.profile_cn.check_cn raises otherwise); the
    instantiations that run at full width must have no stack frame and no
    spill.  Logs one line per width; returns (the full-width result, the
    plain version's output there: the VN kernel's input)."""
    from lut_ldpc_torch import profile_cn as pc
    from lut_ldpc_torch.decoder import qc_kernels as qk

    m_vn = pc.cn_input(dec, it, B, seed)
    rows = {(r["kernel"], r["dtype"], r["width"], r["vec"]): r
            for r in qk.ptxas_cn_frames(BUILD_REPORT[0])}
    for key in pc.instantiations(dec, B):
        r = rows[key]
        if r["stack"] or r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"{what}: {key} has {r['stack']} B stack, "
                                 f"{r['spill_stores'] + r['spill_loads']} B spills")
    bnd = bounds(dec, B)["cn"]
    full = None
    for width in (B, B - 3):
        x = m_vn if width == B else m_vn[:, :width].contiguous()
        r = pc.check_cn(dec, x, reps=reps if width == B else max(2, reps // 4),
                        plain_reps=plain_reps if width == B else 0)
        log(f"# {what} B={width}: {r['name']} frames equal to the table-driven kernel and "
            f"the plain version; frames {r['ms']:.4f} ms, table-driven {r['witness_ms']:.4f} ms"
            + (f", unfolded route (two gathers + frames) {r['unfolded_ms']:.4f} ms"
               if r["unfolded_ms"] else "")
            + (f", plain {r['plain_ms']:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); "
               + "; ".join(pc.describe_instantiations(dec, B, BUILD_REPORT[0]))
               if width == B else "") + f"; synd true {r['synd_true']}/{width}")
        full = full or r
    cn_ref = qk.cn_qc_pass_ref if dec.loop == "qc" else qk.cn_std_pass_ref
    return full, cn_ref(m_vn, dec.tables)[0]


def kernel_vs_twin(dec, it, seed, B, what):
    """CN then VN kernel of `dec`'s path (QC or std) against the table-driven
    kernel and the plain version; the VN kernel reads the CN plain version's
    output (CN-grouped on the QC path, VN-grouped on the std path, padding
    rows as that left them).  Returns {kernel name: result dict}."""
    import numpy as np
    import torch

    qc = dec.loop == "qc"
    r_cn, m_c2v = cn_check(dec, it, B, what, 20 if qc else 10, 3 if qc else 1, seed)
    rng = np.random.default_rng(seed + 1)
    cha_t = torch.as_tensor(np.asarray(dec.spec.leaf_cha), device=dec.device).to(dec.dtype)
    cha = cha_t[torch.as_tensor(rng.integers(0, len(cha_t), (dec.tables.nvar_pad, B)),
                                device=dec.device)]
    r = vn_check(dec, it, m_c2v, cha, what, 20 if qc else 5, 3 if qc else 1)
    log(f"#   unan true {r['unan_true']}/{B}")
    return {r_cn["name"]: r_cn, r["name"]: r}


def kernels_both_specs(codec, dev, B, phase, results):
    """Phase 3 / 7: both kernels of the codec's path against their twins in
    the int16 and the float32 prefix spec; fills `results` per kernel."""
    import numpy as np

    from lut_ldpc_torch.decoder import ArithLUTDecoder, build_arith_prefix_spec

    for dt in (np.int16, np.float32):
        spec = build_arith_prefix_spec(codec, dtype=dt)
        dec = ArithLUTDecoder(codec, dev, spec=spec)
        it = spec.num_iters // 2
        res = kernel_vs_twin(dec, it, 1, B, f"phase {phase}: {np.dtype(dt).name} it={it}")
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
        for name, r in res.items():
            b_ms, b_by = bnd[name[:2]]
            if dt == np.int16:
                results[name] = dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                                     plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                                     library_ms=None)
                results[name]["witness_ms"] = r.get("witness_ms", r.get("generic_ms"))
                if r.get("unfolded_ms"):
                    results[name]["unfolded_ms"] = r["unfolded_ms"]
            else:
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                                   r["max_abs_err"])
        del dec


def start_vn_builds(codecs, libs):
    """Phase 2: start one nvcc for the generated VN unit of every spec the
    later phases decode with (found through a decoder on the CPU, which
    needs no library); none waits for another.  codecs: name -> (codec,
    [(spec function, dtype, loops)]), loops among "auto" (the decoder's own
    loop), "std" (the spec's std unit: phase 10 compares the block kernels
    with it) and "blocks"; fills libs: unit key -> (label, VNLibrary,
    classes)."""
    import numpy as np

    from lut_ldpc_torch.decoder import ArithLUTDecoder, vn_codegen

    for name, (codec, spec_fns) in codecs.items():
        for build, dt, loops in spec_fns:
            spec = build(codec, dtype=dt)
            dec = ArithLUTDecoder(codec, "cpu", spec=spec)
            label = f"{name} {np.dtype(dt).name}"
            for loop in loops:
                if loop == "blocks":
                    blocks = ArithLUTDecoder(codec, "cpu", spec=spec, loop="blocks")
                    key = (tuple(p.key for p in blocks._progs), blocks.dtype, loop)
                    if key not in libs:
                        libs[key] = (f"{label} blocks", vn_codegen.start_block_build(
                            blocks._progs, blocks.dtype, force=True), blocks._progs)
                    continue
                kind = dec.loop if loop == "auto" else loop
                key = (dec.params.tree_key, dec.dtype, kind)
                if key not in libs:  # specs of one structure share a unit
                    libs[key] = (f"{label} {kind}",
                                 vn_codegen.start_build(dec.params, dec.dtype, kind,
                                                        force=True),
                                 dec.params.classes)


def finish_builds(builds, libs):
    """Phase 2: wait for every build (raises if one failed), print what
    ptxas reports; no generated block kernel may have a stack frame or
    spill."""
    from lut_ldpc_torch import profile_vn as pv
    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.decoder.vn_codegen import ptxas_by_kernel

    for b in builds.values():
        b.wait()
    log("# phase 2: kernel library built side by side: " + ", ".join(
        f"{unit} {b.seconds:.1f}s" for unit, b in builds.items()))
    BUILD_REPORT.append(builds["cn_frames_int16"].report
                        + builds["cn_frames_float32"].report)
    log(f"#   {len(qk.ptxas_cn_frames(BUILD_REPORT[0]))} CN frame instantiations")
    for line in ptxas_summary(builds["qc_kernels"].report):
        log(f"#   ptxas {line}")
    qc_n64800_gate(BUILD_REPORT[0])
    for label, lib, classes in libs.values():
        lib.handle()
        for line in pv.describe_build(lib, classes):
            log(f"# phase 2: generated VN kernels, {label}: {line}")
        for r in ptxas_by_kernel(lib.report):
            if r["kernel"] == "vn_block_class_kernel" and (
                    r["stack"] or r["spill_stores"] or r["spill_loads"]):
                raise AssertionError(f"{label}: block class {r['cls']} x{r['vec']} has "
                                     f"{r['stack']} B stack, "
                                     f"{r['spill_stores'] + r['spill_loads']} B spills")


def qc_n64800_gate(report):
    """Phase 2: the CN frames that the QC N=64800 decode (``bench_n64800
    --code qc``, which no phase runs) launches, at its check degrees in
    int16 and float32 at B=4096, must have no stack frame and no spill."""
    from lut_ldpc_torch import bench_n64800 as b64
    from lut_ldpc_torch.core import qc
    from lut_ldpc_torch.decoder import qc_kernels as qk

    rows = {(r["kernel"], r["dtype"], r["width"], r["vec"]): r
            for r in qk.ptxas_cn_frames(report)}
    degrees = sorted({int(d) for d in (qc.load_qc(b64.QC_JSON).base >= 0).sum(axis=1)})
    for dt, is_f32 in (("int16", 0), ("float32", 1)):
        lib = qk._load_cn(is_f32)
        for d in degrees:
            key = ("cn_qc_frames_kernel", dt, lib.lut_cn_width(d),
                   lib.lut_cn_vec(is_f32, d, b64.BATCH, 1))
            r = rows[key]
            if r["stack"] or r["spill_stores"] or r["spill_loads"]:
                raise AssertionError(f"QC N=64800: {key} has {r['stack']} B stack, "
                                     f"{r['spill_stores'] + r['spill_loads']} B spills")
            log(f"# phase 2: QC N=64800 check degree {d}: {key[0]}<{dt}, width {key[2]}, "
                f"{key[3]} frames a thread>: {r['registers']} registers, no stack, "
                f"no spill")


def frames_only(name, per_pass):
    """After a main-path decode: every pass of `name` went through the CN
    frames, the CN block kernel or the generated VN kernels (per_pass class
    launches each), none through the table-driven witness.  Returns the
    class launches."""
    from lut_ldpc_torch.decoder import qc_kernels as qk

    got, want = qk.CLASS_LAUNCHES[name], qk.LAUNCHES[name] * per_pass
    if got != want or want < 1:
        raise AssertionError(f"{name}: {got} class launches in "
                             f"{qk.LAUNCHES[name]} passes, expected {want}")
    log(f"#   {name}: {qk.LAUNCHES[name]} passes, none on the table-driven kernel "
        f"({got} class launches)")
    return got


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


def headline(dev, smi, codec, results, launches):
    """Phases 3-6: the N=10000 QC headline of lut_ldpc_torch.bench."""
    import numpy as np
    import torch

    from lut_ldpc_torch import bench
    from lut_ldpc_torch.decoder import HybridLUTDecoder, make_staged_decoder
    from lut_ldpc_torch.decoder import qc_kernels as qk

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
    tab = dec.pre.tables
    results["cn_qc_pass"]["class_launches"] = frames_only("cn_qc_pass", len(tab.cn_runs))
    results["vn_qc_pass"]["class_launches"] = frames_only("vn_qc_pass", len(tab.vn_runs))
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
    kern = sum(ms for name, _, ms in rows
               if "_qc_frames_kernel" in name or "_qc_class_kernel" in name)
    log(f"#   traced decode: wall {wall:.3f} ms, device span {span:.3f} ms, busy "
        f"{busy:.3f} ms (CN+VN kernels {kern:.3f}, torch glue {busy - kern:.3f}), "
        f"idle {100 * (1 - busy / span):.1f} % of the span")
    return dec, lc_d, lm_d


def peg(dev, smi, codec, lc, lm, rank, results, launches):
    """Phases 7-9: the N=64800 PEG code of lut_ldpc_torch.bench_n64800;
    returns (frame 0's decoded bits and iteration count, k)."""
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
    tab = inner.pre.tables
    results["cn_std_pass"]["class_launches"] = frames_only("cn_std_pass", len(tab.cn_blocks))
    results["vn_std_pass"]["class_launches"] = frames_only("vn_std_pass", len(tab.vn_blocks))
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
    frame0 = out[0][0].cpu().numpy(), int(iters[0])

    k, secs = rank.get()
    log(f"#   k={k} (GF(2) rank in {secs:.1f}s in a worker process)")
    dt_s, out = bench.time_decode(dec, lc_d, lm_d, 3)
    mbits = B * k / dt_s / 1e6
    log(f"# phase 9: PEG N=64800 {mbits:.3f} Mbit/s ({dt_s * 1e3:.3f} ms per {B} frames, "
        f"mean iters {float(out[2].float().mean()):.4f}, ok {float(out[1].float().mean()):.6f}) "
        f"on {smi}")
    return frame0, k


def block_kernels(dev, head_codec, peg_codec, results):
    """Phase 10: cn_block_pass / vn_block_pass against their plain versions,
    the VN block kernel also against the table-driven witness and the
    generated std class kernel on the same planes."""
    import numpy as np

    from lut_ldpc_torch import profile_kernels as pk
    from lut_ldpc_torch.decoder import ArithLUTDecoder, build_arith_prefix_spec

    for dt in (np.int16, np.float32):
        name = np.dtype(dt).name
        spec = build_arith_prefix_spec(head_codec, dtype=dt)
        dec = ArithLUTDecoder(head_codec, dev, spec=spec, loop="blocks")
        for B in (4096, 4093):
            full = B == 4096
            for r in pk.check_blocks(dec, spec.num_iters // 2, B, chain=32 if full else 0,
                                     plain_reps=2 if full else 0):
                log(f"# phase 10: {pk.describe(r, name, B)}")
                key = f"{r['kind']}_block_pass"
                if dt == np.int16 and full:
                    results[key] = dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                                        bound_by=r["bound_by"], library_ms=None)
                    if r["kind"] == "vn":
                        results[key]["witness_ms"] = r["witness_ms"]
                else:
                    results[key]["max_abs_err"] = max(results[key]["max_abs_err"],
                                                      r["max_abs_err"])
        del dec
        spec = build_arith_prefix_spec(peg_codec, dtype=dt)
        dec = ArithLUTDecoder(peg_codec, dev, spec=spec, loop="blocks")
        for r in pk.check_blocks(dec, spec.num_iters // 2, 4096, reps=5, plain_reps=1):
            log(f"# phase 10: PEG block: {pk.describe(r, name, 4096)}")
        del dec


def block_loop(dev, smi, codec, dec, lc_d, lm_d, launches, results):
    """Phase 11: the headline batch on the per-degree-block loop."""
    import torch

    from lut_ldpc_torch import bench
    from lut_ldpc_torch.decoder import ArithLUTDecoder
    from lut_ldpc_torch.decoder import qc_kernels as qk

    B = lc_d.shape[0]
    blocks = ArithLUTDecoder(codec, dev, spec=dec.pre.spec, loop="blocks")
    if blocks.loop != "blocks" or dec.pre.loop != "qc" or blocks.dtype != torch.int16:
        raise AssertionError("expected the int16 prefix on the block loop and the QC loop")
    qk.reset_launches()
    out = blocks(lc_d, lm_d)
    torch.cuda.synchronize()
    for name in ("cn_block_pass", "vn_block_pass"):
        launches[name] = qk.LAUNCHES[name]
        if launches[name] < 1:
            raise AssertionError(f"the block loop skipped {name}")
    results["cn_block_pass"]["class_launches"] = frames_only("cn_block_pass", 1)
    results["vn_block_pass"]["class_launches"] = frames_only(
        "vn_block_pass", len(blocks.layout.vn_blocks))
    if qk.LAUNCHES["cn_qc_pass"] or qk.LAUNCHES["vn_qc_pass"]:
        raise AssertionError("the block loop launched a QC kernel")
    check_shapes(out, B, codec.nvar)
    same(out, dec.pre(lc_d, lm_d), "block loop vs QC-kernel loop")
    dt_s, _ = bench.time_decode(blocks, lc_d, lm_d, 3)
    log(f"# phase 11: block loop S={blocks.S} B={B}: launches "
        f"{ {n: launches[n] for n in ('cn_block_pass', 'vn_block_pass')} }, bits, ok "
        f"and iters equal to the QC-kernel decode; ok {float(out[1].float().mean()):.6f}, "
        f"mean iters {float(out[2].float().mean()):.4f}, {dt_s * 1e3:.3f} ms a decode "
        f"({B * codec.k / dt_s / 1e6:.3f} Mbit/s) on {smi}")


def peg_block_loop(dev, smi, codec, lc, lm, k):
    """Phase 11, second part: the PEG N=64800 int16 prefix at full width on
    the per-degree-block loop (its degree-17 block among them) against the
    same prefix on the std loop."""
    import numpy as np
    import torch

    from lut_ldpc_torch import bench
    from lut_ldpc_torch.decoder import ArithLUTDecoder, build_arith_prefix_spec
    from lut_ldpc_torch.decoder import qc_kernels as qk

    lc_d, lm_d = torch.as_tensor(lc, device=dev), torch.as_tensor(lm, device=dev)
    B = lc_d.shape[0]
    spec = build_arith_prefix_spec(codec, dtype=np.int16)
    std = ArithLUTDecoder(codec, dev, spec=spec)
    std_s, want = bench.time_decode(std, lc_d, lm_d, 2, warmup=1)
    del std
    blocks = ArithLUTDecoder(codec, dev, spec=spec, loop="blocks")
    if blocks.loop != "blocks" or 17 not in [b.degree for b in blocks.layout.vn_blocks]:
        raise AssertionError("expected the PEG prefix on the block loop")
    qk.reset_launches()
    out = blocks(lc_d, lm_d)
    torch.cuda.synchronize()
    if qk.LAUNCHES["cn_std_pass"] or qk.LAUNCHES["vn_std_pass"]:
        raise AssertionError("the block loop launched a std kernel")
    frames_only("cn_block_pass", 1)
    frames_only("vn_block_pass", len(blocks.layout.vn_blocks))
    check_shapes(out, B, codec.nvar)
    same(out, want, "PEG block loop vs std loop")
    del want
    dt_s, _ = bench.time_decode(blocks, lc_d, lm_d, 2, warmup=1)
    log(f"# phase 11: PEG N=64800 int16 prefix S={blocks.S} B={B} on the block loop: bits, "
        f"ok and iters equal to the std loop; ok {float(out[1].float().mean()):.6f}, mean "
        f"iters {float(out[2].float().mean()):.4f}, {dt_s * 1e3:.3f} ms a decode "
        f"({B * k / dt_s / 1e6:.3f} Mbit/s; std loop {std_s * 1e3:.3f} ms, "
        f"{B * k / std_s / 1e6:.3f} Mbit/s) on {smi}")


def phantom_toy(dev):
    """Phase 12: a (3,6) QC graph with one phantom edge on a degree-3
    variable (true degree 2): the block loop is the only loop for it."""
    import dataclasses

    import numpy as np
    import torch

    from lut_ldpc_torch.core import qc
    from lut_ldpc_torch.decoder import ArithLUTDecoder, LUTCodec, make_decoder
    from lut_ldpc_torch.decoder import qc_kernels as qk

    Z = 16
    st = qc.qc_generate_regular(3, 6, Z=Z, nb=8, seed=1)
    i = int(np.nonzero(st.base[:, 0] >= 0)[0][0])
    st = dataclasses.replace(st, phantoms=((0, 3, i, (3 + int(st.base[i, 0])) % Z),))
    codec = LUTCodec.design(qc.qc_expand(st), 0.7**2, max_iters=8, Nq_Cha=16, Nq_Msg=16)
    dec = make_decoder(codec, dev)
    if not isinstance(dec, ArithLUTDecoder) or dec.loop != "blocks" or dec._ph[0]["td"] != 2:
        raise AssertionError("expected the block loop for a true-degree-2 phantom node")
    rng = np.random.default_rng(1)
    y = 1.0 + 0.7 * rng.standard_normal((64, codec.nvar))
    lc, lm = codec.quantize_channel(2.0 * y / 0.7**2)
    qk.reset_launches()
    out = dec(torch.as_tensor(lc, device=dev), torch.as_tensor(lm, device=dev))
    torch.cuda.synchronize()
    frames_only("vn_block_pass", len(dec.layout.vn_blocks))
    bits, ok, iters = (o.cpu().numpy() for o in out)
    for f in range(64):
        b_ref, it_ref = codec.decode_ref(lc[f], lm[f])
        if (not np.array_equal(np.asarray(b_ref), bits[f]) or abs(it_ref) != iters[f]
                or (it_ref > 0) != ok[f]):
            raise AssertionError(f"phantom toy frame {f} differs from decode_ref")
    log(f"# phase 12: true-degree-2 phantom graph N={codec.nvar}, {dec.dtype}: 64 frames "
        f"equal to decode_ref (iters {int(iters.min())}-{int(iters.max())}, ok "
        f"{float(ok.mean()):.3f}), launches {dict(qk.LAUNCHES)}")


def dvbs2(dev, smi, codec, codec_g, lc, lm):
    """Phases 13-14: the DVB-S2 standard matrix of lut_ldpc_torch.bench_n64800;
    returns frame 0's decoded bits and iteration count."""
    import torch

    from lut_ldpc_torch import bench, bench_n64800 as b64
    from lut_ldpc_torch.decoder import ArithLUTDecoder, make_staged_decoder
    from lut_ldpc_torch.decoder import qc_kernels as qk

    B = b64.BATCH
    graph = codec.graph
    lc_d, lm_d = torch.as_tensor(lc, device=dev), torch.as_tensor(lm, device=dev)
    t0 = time.perf_counter()
    dec = make_staged_decoder(codec, dev, max_batch=B)
    if (not isinstance(dec, ArithLUTDecoder) or dec.loop != "qc" or dec.is_prefix
            or dec.dtype != torch.float32 or [p["td"] for p in dec._ph] != [1]):
        raise AssertionError(f"expected the full float32 ArithLUTDecoder on the QC loop "
                             f"with one true-degree-1 phantom, got {type(dec).__name__}")
    log(f"# phase 13: {type(dec).__name__} ({dec.dtype}, loop {dec.loop}, S={dec.S}) built "
        f"in {time.perf_counter() - t0:.1f}s")
    from lut_ldpc_torch import profile_vn as pv

    it = dec.S // 2
    what = f"phase 13: DVB-S2 float32 it={it}"
    cn_check(dec, it, B, what, 10, 1)
    m_c2v, cha = pv.vn_input(dec, it, B)
    r = vn_check(dec, it, m_c2v, cha, what, 5, 1)
    log(f"#   unan true {r['unan_true']}/{B}")
    del m_c2v, cha
    torch.cuda.empty_cache()
    qk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = dec(lc_d, lm_d)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    by_dtype = {f"{n}/{dt}": c for (n, dt), c in qk.LAUNCHES_BY_DTYPE.items() if c}
    for name in ("cn_qc_pass", "vn_qc_pass"):
        if qk.LAUNCHES_BY_DTYPE[name, "float32"] < 1:
            raise AssertionError(f"DVB-S2 path launched no {name} in float32: {by_dtype}")
    frames_only("cn_qc_pass", len(dec.tables.cn_runs))
    frames_only("vn_qc_pass", len(dec.tables.vn_runs))
    check_shapes(out, B, codec.nvar)
    bits, ok, iters = out
    bnd = bounds(dec, B)
    log(f"#   launches {by_dtype}; ok {float(ok.float().mean()):.6f}, mean iters "
        f"{float(iters.float().mean()):.4f}, peak device memory {peak:.2f} GiB; bounds "
        f"a launch: CN {bnd['cn'][0]:.4f} ms ({bnd['cn'][1]}), VN {bnd['vn'][0]:.4f} ms "
        f"({bnd['vn'][1]})")
    n = 256
    twin = ArithLUTDecoder(codec, dev, spec=dec.spec, kernels=False)
    t0 = time.perf_counter()
    same([o[:n] for o in out], twin(lc_d[:n], lm_d[:n]), "DVB-S2 kernel path vs twin path")
    log(f"#   twin path on the card, first {n} frames: identical bits, ok, iters "
        f"({time.perf_counter() - t0:.1f}s)")
    del twin
    dt_s, out_t = bench.time_decode(dec, lc_d, lm_d, 3)
    same(out, out_t, "DVB-S2 decode repeated")
    log(f"#   DVB-S2 N=64800 {B * codec.k / dt_s / 1e6:.3f} Mbit/s ({dt_s * 1e3:.3f} ms per "
        f"{B} frames) on {smi}")

    # the same matrix unpermuted, every variable's edges in the permuted
    # graph's order: a degree-1 variable instead of the phantom edge
    n = 512
    perm = torch.as_tensor(graph.qc_col_perm, device=dev)
    t0 = time.perf_counter()
    dec_g = make_staged_decoder(codec_g, dev, max_batch=n)
    if (not isinstance(dec_g, ArithLUTDecoder) or dec_g.loop != "std" or dec_g._ph
            or dec_g.dtype != torch.float32 or 1 not in codec_g.graph.vn_degrees):
        raise AssertionError("expected the float32 ArithLUTDecoder on the std loop")
    qk.reset_launches()
    out_g = dec_g(lc_d[:n][:, perm].contiguous(), lm_d[:n][:, perm].contiguous())
    torch.cuda.synchronize()
    frames_only("cn_std_pass", len(dec_g.tables.cn_blocks))
    frames_only("vn_std_pass", len(dec_g.tables.vn_blocks))
    same((bits[:n][:, perm], ok[:n], iters[:n]), out_g, "DVB-S2 permuted vs unpermuted")
    log(f"# phase 14: unpermuted matrix on the std kernels ({time.perf_counter() - t0:.1f}s "
        f"with the decoder's build), {n} frames: launches {dict(qk.LAUNCHES)}; ok and iters "
        f"equal to the permuted decode, bits equal after un-permuting")
    return bits[0].cpu().numpy(), int(iters[0])


def check_worker_golden(what, golden, frame0, max_iters):
    import numpy as np

    b_ref, it_ref, secs = golden.get()
    itr = it_ref if it_ref > 0 else max_iters
    if not np.array_equal(np.asarray(b_ref), frame0[0]) or itr != frame0[1]:
        raise AssertionError(f"{what} frame 0 differs from decode_ref")
    log(f"# phase 15: {what} frame 0: decode_ref agrees (iters {itr}, {secs:.1f}s in a "
        f"worker process)")


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

    import numpy as np

    from lut_ldpc_torch import bench, bench_n64800 as b64
    from lut_ldpc_torch.decoder import (LUTCodec, build_arith_prefix_spec,
                                        build_arith_spec)
    from lut_ldpc_torch.decoder import qc_kernels as qk

    dev = torch.device("cuda")
    os.environ.setdefault("LUT_DECODE_MEM_BUDGET", str(b64.MEM_BUDGET))

    t0 = time.perf_counter()
    head_codec = bench.build_codec()
    log(f"# phase 2: headline codec designed in {time.perf_counter() - t0:.1f}s "
        f"(N={head_codec.nvar}, k={head_codec.k}, {head_codec.max_iters} iterations)")
    t0 = time.perf_counter()
    codec = b64.build_codec("peg")
    log(f"#   PEG codec designed in {time.perf_counter() - t0:.1f}s (N={codec.nvar}, "
        f"{codec.graph.num_edges} edges, {codec.max_iters} iterations)")
    t0 = time.perf_counter()
    dvb_codec = b64.build_codec("dvbs2")
    log(f"#   DVB-S2 codec designed in {time.perf_counter() - t0:.1f}s (N={dvb_codec.nvar}, "
        f"Z={dvb_codec.graph.qc.Z}, {dvb_codec.graph.num_edges} edges with "
        f"{len(dvb_codec.graph.phantoms)} phantom, k={dvb_codec.k})")
    # per spec the loops phases 3-14 run it on
    prefix = [(build_arith_prefix_spec, dt, ("auto", "std", "blocks"))
              for dt in (np.int16, np.float32)]
    full = [(build_arith_spec, np.float32, ("auto",))]
    results, launches = {}, {}
    # the golden model takes minutes a frame at N=64800: its two workers
    # start as soon as their labels exist and run beside everything below
    # (two of the host's cores); leaving the block terminates the workers,
    # also after a failure
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        lc, lm = bench.channel_labels(codec, b64.BATCH, b64.SNR_DB)
        golden = pool.apply_async(b64.golden_frame, ("peg", lc[0], lm[0]))
        t0 = time.perf_counter()
        builds, libs = qk.start_builds(force=True), {}
        start_vn_builds({"headline": (head_codec, prefix), "PEG": (codec, prefix + full),
                         "DVB-S2": (dvb_codec, full)}, libs)
        dvb_lc, dvb_lm = bench.channel_labels(dvb_codec, b64.BATCH, b64.SNR_DB)
        golden_dvb = pool.apply_async(b64.golden_frame, ("dvbs2", dvb_lc[0], dvb_lm[0]))
        # the unpermuted DVB-S2 matrix: designed while the compilers run
        dvb_codec_g = LUTCodec.design(b64.unpermuted_graph(dvb_codec.graph),
                                      b64.DESIGN_THR**2, max_iters=b64.MAX_ITERS,
                                      Nq_Cha=16, Nq_Msg=16)
        start_vn_builds({"DVB-S2 unpermuted": (dvb_codec_g, full)}, libs)
        finish_builds(builds, libs)
        log(f"#   {len(builds) + len(libs)} libraries built side by side in "
            f"{time.perf_counter() - t0:.1f}s")
        head_dec, head_lc, head_lm = headline(dev, smi, head_codec, results, launches)
        torch.cuda.empty_cache()
        # the PEG rank (a third busy worker) starts after the headline's
        # timed phase
        rank = pool.apply_async(b64.info_bits, ("peg",))
        peg_frame0, peg_k = peg(dev, smi, codec, lc, lm, rank, results, launches)
        torch.cuda.empty_cache()
        block_kernels(dev, head_codec, codec, results)
        block_loop(dev, smi, head_codec, head_dec, head_lc, head_lm, launches, results)
        del head_dec, head_lc, head_lm
        torch.cuda.empty_cache()
        peg_block_loop(dev, smi, codec, lc, lm, peg_k)
        phantom_toy(dev)
        torch.cuda.empty_cache()
        dvb_frame0 = dvbs2(dev, smi, dvb_codec, dvb_codec_g, dvb_lc, dvb_lm)
        check_worker_golden("PEG", golden, peg_frame0, codec.max_iters)
        check_worker_golden("DVB-S2", golden_dvb, dvb_frame0, codec.max_iters)

    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=SOURCES[n], replaces=REPLACES[n],
             launches=launches[n], **results[n])
        for n in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
