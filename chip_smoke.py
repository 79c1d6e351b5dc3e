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
    the CN frames' widest bucket (width 40: checks of degree 17 to 40) and
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
    workers (read after phases 16, 18 and 19, which run while the workers
    finish; phase 17 runs last, on a host without workers);
16. the float BP baselines (lut_ldpc_torch.decoder.bp, torch ops) at the
    headline code, B=8192, 2 dB, 50 iterations: spa, minsum, nms, oms and
    qllr, the first 256 frames against the same decoder on the CPU (equal
    bits, ok and iters; spa ok and iters on 99 % of the frames), Mbit/s and
    peak memory;
17. the simulator's step at the headline configuration (BERSim, zero
    codeword, B=8192, 2 dB, the HybridLUTDecoder of phase 4), after the
    workers have ended: the decode alone on one of its batches, then 6
    batches after a warm-up, frames/s and Mbit/s beside the decode-only
    figure of this phase and of phase 6, the counters, the kernel launches
    of that run (none on a witness), the step split into generate /
    quantize / decode / count;
18. the N=1000 PEG (3,6) waterfall of examples/ber_waterfall.py (q4
    min-LUT on the std kernels, spa, nms), every point's frame errors
    against the TPU-era docs/waterfall/{lut_q4,spa,nms}.npz (two-sided
    two-proportion test, alpha = 1e-3), the LUT run's launches; then the
    LUT decoder's CN frames and generated VN kernel at B=256 and 253
    against their plain versions and table-driven kernels, and one batch
    on the kernels against the twin path;
19. the ber_sim CLI of the port on params/ber.ini.regular.example (results
    in a temporary directory): its files under the JAX CLI's names, read
    back, each point against docs/waterfall/lut_10gbaset_q4q3.npz, every
    pass on the CN frames and the generated VN kernel; then the kernels of
    the decoder of the codec it saved at B=128 and 125 as in phase 18 (the
    CN frames against the plain version only: no table-driven CN kernel
    takes checks of degree 33);
20. after phase 17, the batched density-evolution explorers (torch ops on
    the card, no hand-written kernel) and their CLIs: (a) DELutGPU on the
    published irregular q4 ensemble (joint_root, 2000 iterations),
    threshold(points=9, rounds=3) within 2e-3 of 0.929193, its wall time,
    DE iterations per round, ms per DE iteration with the CUDA graph and
    eager (outputs equal), kernels per eager iteration, peak memory; (b)
    the first grid round at 400 iterations twice on the card (array_equal)
    and once on the CPU (equal decisions more than 0.01 from the
    threshold), the same for DEBpGPU on the (3,6) ensemble at Nb=9 with its
    threshold within 3e-3 of 0.88046; (c) prerank_reuse over the 99
    single-reuse candidates of reuse_vec_opt's first round at sigma 0.82,
    100 iterations: the top 10 equal to the CPU's at pmax 1e-4 (printed,
    not held, at 1e-6, below the f32 floor); (d) the de_sim CLI with and
    without accelerator_sweep (thresholds within thr_prec) and
    reuse_vec_opt --accel 8, each in a process of its own.
Every main-path decode (phases 4, 8, 11, 13, 14, 17, 18, 19) must have run each
CN and VN pass on the CN frames, the CN block kernel or the generated VN
kernels, none on a table-driven witness.  Then a JSON line of per-kernel results
(time, plain twin's time, the card's bound for the same work; `launches`
counts the wrapper's calls on the main path (one a pass; one a degree block
for `cn_block_pass`), `class_launches` the kernel launches these made, one
a degree class, block or run of block-rows; the rows of the CN frames and
of the generated VN kernels also carry `witness_ms`, the table-driven
kernel's time, and `cn_std_pass` `unfolded_ms`; the QC pair's
`sim_launches` are the passes of phase 17's simulator run, the std pair's
those of phase 18's LUT run), the card, and last the device line.
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


def vn_check(dec, it, m_c2v, cha, what, reps, plain_reps, hold_speed=True):
    """The generated VN kernel of `dec` at iteration `it` on (m_c2v, cha) and
    on the same input cut to an odd width (3 frames fewer: one frame a
    thread, unaligned rows): equal to the table-driven kernel and to the
    plain version (lut_ldpc_torch.profile_vn.check_vn raises otherwise), and,
    with hold_speed, faster than the table-driven kernel.  Logs one line per
    width; returns the full-width result."""
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
        if hold_speed and r["ms"] >= r["generic_ms"]:
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
        log(f"# {what} B={width}: {r['name']} frames equal to "
            + (f"the table-driven kernel and the plain version; frames {r['ms']:.4f} ms, "
               f"table-driven {r['witness_ms']:.4f} ms" if r["witness_ms"] is not None else
               f"the plain version (no table-driven kernel above check degree "
               f"{qk.MAX_DEGREE}); frames {r['ms']:.4f} ms")
            + (f", unfolded route (two gathers + frames) {r['unfolded_ms']:.4f} ms"
               if r["unfolded_ms"] else "")
            + (f", plain {r['plain_ms']:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); "
               + "; ".join(pc.describe_instantiations(dec, B, BUILD_REPORT[0]))
               if width == B else "") + f"; synd true {r['synd_true']}/{width}")
        full = full or r
    cn_ref = qk.cn_qc_pass_ref if dec.loop == "qc" else qk.cn_std_pass_ref
    return full, cn_ref(m_vn, dec.tables)[0]


def kernel_vs_twin(dec, it, seed, B, what, hold_speed=True):
    """CN then VN kernel of `dec`'s path (QC or std) against the table-driven
    kernel and the plain version; the VN kernel reads the CN plain version's
    output (CN-grouped on the QC path, VN-grouped on the std path, padding
    rows as that left them).  hold_speed: the generated VN kernel must beat
    the table-driven one.  Returns {kernel name: result dict}."""
    import numpy as np
    import torch

    qc = dec.loop == "qc"
    r_cn, m_c2v = cn_check(dec, it, B, what, 20 if qc else 10, 3 if qc else 1, seed)
    rng = np.random.default_rng(seed + 1)
    cha_t = torch.as_tensor(np.asarray(dec.spec.leaf_cha), device=dec.device).to(dec.dtype)
    cha = cha_t[torch.as_tensor(rng.integers(0, len(cha_t), (dec.tables.nvar_pad, B)),
                                device=dec.device)]
    r = vn_check(dec, it, m_c2v, cha, what, 20 if qc else 5, 3 if qc else 1, hold_speed)
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


def sim_kernels(sim, snr_db, what):
    """Phases 18 and 19: the kernels of a simulator's LUT decoder at the
    shapes its run gave them.  The CN frames and the generated VN kernel of
    its arithmetic prefix at the run's batch width B (and B - 3), on a
    middle iteration, against their plain versions and the table-driven
    kernels (the CN one only up to its check degree 32), no stack or spill
    in a CN frame instantiation that runs, times logged but not held; then
    one batch of the simulator's own draw at snr_db through the prefix on
    the kernels and on the twin path (kernels=False): equal bits, ok and
    iters."""
    import torch

    from lut_ldpc_torch.decoder import ArithLUTDecoder
    from lut_ldpc_torch.ops.pmf import snr2sig

    dec = getattr(sim.decoder, "pre", sim.decoder)
    B, it = sim.config.sim.batch_size, dec.spec.num_iters // 2
    kernel_vs_twin(dec, it, 1, B, f"{what} {dec.dtype} it={it}", hold_speed=False)
    sigma = torch.tensor(float(snr2sig(sim.rate, snr_db)), dtype=torch.float32,
                         device=sim.device)
    lc, lm = sim.quantize(sim.draw(0, 0, 0, sigma)[2])
    out = dec(lc, lm)
    twin = ArithLUTDecoder(dec.codec, sim.device, early_exit=dec.early_exit,
                           spec=dec.spec, kernels=False,
                           loop="blocks" if dec.loop == "blocks" else "auto")
    same(out, twin(lc, lm), f"{what}: kernel path vs twin path")
    log(f"# {what}: one batch of {B} frames at {snr_db:g} dB through the {dec.S}-iteration "
        f"prefix: kernel path and twin path identical (ok "
        f"{float(out[1].float().mean()):.4f}, mean iters {float(out[2].float().mean()):.3f})")


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
    widest_bucket_gate(BUILD_REPORT[0])
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


def widest_bucket_gate(report):
    """Phase 2: the CN frames' widest bucket (checks of degree 17 to
    qc_kernels.MAX_CN_DEGREE, one frame a thread: the 10GBase-T code of
    phase 19), both kernels and storage types, must have no stack frame and
    no spill."""
    from lut_ldpc_torch.decoder import qc_kernels as qk

    rows = [r for r in qk.ptxas_cn_frames(report) if r["width"] == qk.MAX_CN_DEGREE]
    if len(rows) != 4:
        raise AssertionError(f"expected 4 instantiations of width {qk.MAX_CN_DEGREE}, "
                             f"found {len(rows)}")
    for r in rows:
        if r["stack"] or r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"{r['kernel']}<{r['dtype']}, width {r['width']}> has "
                                 f"{r['stack']} B stack, "
                                 f"{r['spill_stores'] + r['spill_loads']} B spills")
    log(f"# phase 2: CN frames' widest bucket, width {qk.MAX_CN_DEGREE}: " + "; ".join(
        f"{r['kernel']}<{r['dtype']}, {r['vec']} frame a thread>: {r['registers']} "
        f"registers" for r in rows) + "; no stack, no spill")


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
    return dec, lc_d, lm_d, mbits, float(iters.float().mean())


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


def bp_baselines(dev, smi, codec):
    """Phase 16: the BP baselines at the headline code and batch (E=30000,
    B=8192, 2 dB, 50 iterations, early exit): per algorithm the first 256
    frames against the same decoder on the CPU (bits, ok and iters equal
    for the four exact algorithms; ok and iters on at least 99 % of the
    frames for spa), decoded Mbit/s (2 warm-ups, 5 calls) and peak device
    memory.  Returns {algorithm: (ms, Mbit/s, peak GiB)}."""
    import torch

    from lut_ldpc_torch import bench
    from lut_ldpc_torch.decoder import BPDecoder
    from lut_ldpc_torch.ops.pmf import snr2sig
    from lut_ldpc_torch.sim import bpsk_awgn_llr

    B, n, g = bench.BATCH, 256, codec.graph
    sigma = torch.tensor(float(snr2sig(0.5, 2.0)), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    llr, _ = bpsk_awgn_llr(gen, torch.zeros((B, g.nvar), dtype=torch.uint8, device=dev),
                           sigma)
    llr_cpu = llr[:n].cpu()
    figures = {}
    for alg in ("spa", "minsum", "nms", "oms", "qllr"):
        dec = BPDecoder(g, dev, 50, algorithm=alg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = dec(llr)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        want = BPDecoder(g, "cpu", 50, algorithm=alg)(llr_cpu)
        cpu_s = time.perf_counter() - t0
        got = [o[:n].cpu() for o in out]
        if alg == "spa":
            agree = [float((w == x).float().mean()) for w, x in zip(want[1:], got[1:])]
            if min(agree) < 0.99:
                raise AssertionError(f"BP spa: ok / iters agree with the CPU on {agree} "
                                     f"of {n} frames (at least 0.99 required)")
            same_cpu = f"ok and iters equal on {agree[0]:.4f} / {agree[1]:.4f} of the frames"
        else:
            same(got, want, f"BP {alg} card vs CPU")
            same_cpu = "bits, ok and iters equal"
        for _ in range(2):
            dec(llr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            rep = dec(llr)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 5
        same(rep, out, f"BP {alg} repeated")
        mbits = B * codec.k / dt / 1e6
        figures[alg] = (dt * 1e3, mbits, peak)
        log(f"# phase 16: BP {alg} B={B}: ok {float(out[1].float().mean()):.6f}, mean iters "
            f"{float(out[2].float().mean()):.4f}; {dt * 1e3:.3f} ms a decode, {mbits:.3f} "
            f"Mbit/s, peak device memory {peak:.2f} GiB on {smi}; first {n} frames against "
            f"the CPU ({cpu_s:.1f}s there): {same_cpu}")
        del dec, out, rep
    return figures


def sim_step(dev, smi, codec, decode_mbits, decode_iters, results):
    """Phase 17, run after the golden-model workers have ended: the
    simulator's step at the headline configuration (BERSim, zero codeword,
    B=8192, 2 dB, make_staged_decoder as bench.py runs it): one warm-up
    batch, the decode alone timed on one of the simulator's batches as
    phase 6 times it, then a run of 6 batches with the launch counts set to
    0 before it; frames/s and Mbit/s beside the decode-only figure of this
    phase and of phase 6; the step split into generate, quantize, decode
    and count (CUDA events, 3 more batches)."""
    import numpy as np
    import torch

    from lut_ldpc_torch import bench
    from lut_ldpc_torch.decoder import HybridLUTDecoder
    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.ops.pmf import snr2sig
    from lut_ldpc_torch.sim import BERSim, BERSimConfig, LDPCConfig, SimConfig

    B, nb = bench.BATCH, 6
    cfg = BERSimConfig(sim=SimConfig(SNRdB=np.array([2.0]), Nframes=B, Nfers=10**9,
                                     batch_size=B), ldpc=LDPCConfig(zero_codeword=True))
    sim = BERSim(cfg, codec.graph, dev, codec=codec)
    if not isinstance(sim.decoder, HybridLUTDecoder) or sim.decoder.S != 32:
        raise AssertionError(f"expected the headline HybridLUTDecoder, got "
                             f"{type(sim.decoder).__name__}")
    sim.run(seed=1, verbose=False)  # warm-up batch
    sigma = torch.tensor(float(snr2sig(sim.rate, 2.0)), dtype=torch.float32, device=dev)
    lc, lm = sim.quantize(sim.draw(0, 0, nb, sigma)[2])
    dt_s, _ = bench.time_decode(sim.decoder, lc, lm, bench.REPS)
    alone_mbits = B * sim.k / dt_s / 1e6
    del lc, lm
    cfg.sim.Nframes = nb * B
    tails = sim.decoder.tail_runs
    qk.reset_launches()
    res = sim.run(seed=0, verbose=False)
    tails = sim.decoder.tail_runs - tails
    torch.cuda.synchronize()
    tab = sim.decoder.pre.tables
    for name, per_pass in (("cn_qc_pass", len(tab.cn_runs)), ("vn_qc_pass", len(tab.vn_runs))):
        results[name]["sim_launches"] = qk.LAUNCHES[name]
        frames_only(name, per_pass)
    frames = int(res.frames[0])
    iters = float(res.mean_iters()[0])
    if frames != nb * B or abs(iters - decode_iters) > 0.5:
        raise AssertionError(f"simulator step: {frames} frames, mean iterations {iters} "
                             f"(phase 4: {decode_iters})")
    if not res.ber()[0] < res.uncoded_ber()[0]:
        raise AssertionError(f"simulator step: data BER {res.ber()[0]}, uncoded "
                             f"{res.uncoded_ber()[0]}")
    fps = frames / res.runtime
    mbits = fps * sim.k / 1e6
    log(f"# phase 17: BERSim step B={B}, {nb} batches in {res.runtime * 1e3:.3f} ms: "
        f"{fps:.1f} frames/s, {mbits:.3f} decoded information Mbit/s (decode only, here: "
        f"{alone_mbits:.3f}, ratio {mbits / alone_mbits:.4f}; phase 6: {decode_mbits:.3f}, "
        f"ratio {mbits / decode_mbits:.4f}); "
        f"mean iters {iters:.4f} (phase 4: {decode_iters:.4f}), FER {res.fer()[0]:.3e}, "
        f"data BER {res.ber()[0]:.3e}, uncoded BER {res.uncoded_ber()[0]:.4e}; {tails} of "
        f"{nb} batches took the table tail (frames past iteration {sim.decoder.S}); launches "
        f"{ {n: c for n, c in qk.LAUNCHES.items() if c} } on {smi}")
    parts, tails = np.zeros(4), sim.decoder.tail_runs
    for bb in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        u, x, llr, y = sim.draw(0, 0, nb + bb, sigma)
        slicer = (y < 0).to(torch.uint8)
        ev[1].record()
        lc, lm = sim.quantize(llr)
        ev[2].record()
        bits, _, it = sim.decoder(lc, lm)
        ev[3].record()
        sim.count(bits, it, u, x, slicer)
        ev[4].record()
        torch.cuda.synchronize()
        parts += [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    parts, tails = parts / 3, sim.decoder.tail_runs - tails
    # the same steps on the host clock, and what a batch's generator costs
    t0 = time.perf_counter()
    for bb in range(3):
        sim.step(0, 0, nb + 3 + bb, sigma)
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    for bb in range(100):
        torch.Generator(device=dev).manual_seed(bb)
    gen_ms = (time.perf_counter() - t0) / 100 * 1e3
    log(f"#   step split (CUDA events, mean of 3 batches): generate {parts[0]:.3f} ms, "
        f"quantize {parts[1]:.3f}, decode {parts[2]:.3f}, count {parts[3]:.3f}; total "
        f"{parts.sum():.3f} ms ({100 * parts[2] / parts.sum():.1f} % decode, "
        f"{tails} of 3 batches with the table tail); "
        f"BERSim.step on the host clock {host_ms:.3f} ms, a run's batch "
        f"{res.runtime / nb * 1e3:.3f} ms; a seeded CUDA generator {gen_ms:.4f} ms")


def fer_test(f1, n1, f2, n2, z_crit=3.2905):
    """Two-sided two-proportion z test of frame-error counts at alpha =
    1e-3: (z, passes)."""
    p = (f1 + f2) / (n1 + n2)
    if p in (0.0, 1.0):
        return 0.0, True
    z = (f1 / n1 - f2 / n2) / (p * (1 - p) * (1 / n1 + 1 / n2)) ** 0.5
    return z, abs(z) <= z_crit


def waterfall(dev, smi, results):
    """Phase 18: the N=1000 PEG (3,6) waterfall of examples/ber_waterfall.py
    (SNR 1.0:0.25:3.5 dB, Nframes 4096, Nfers 200, batch 256, zero codeword,
    seed 0, ber_min 1e-7) for the q4 min-LUT codec (thr 0.85), spa and nms
    (50 iterations each), each point's frame errors held against the
    TPU-era docs/waterfall/{lut_q4,spa,nms}.npz by a two-sided
    two-proportion test at alpha = 1e-3."""
    import numpy as np

    from lut_ldpc_torch.core.tanner import TannerGraph
    from lut_ldpc_torch.decoder import BPDecoder, HybridLUTDecoder, LUTCodec
    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.sim import BERSim, BERSimConfig, LDPCConfig, SimConfig
    from lut_ldpc_torch.sim.config import _parse_range

    graph = TannerGraph.from_alist("codes/rate0.50_dv03_dc06_N1000.alist")
    snr = _parse_range("1.0:0.25:3.5")

    def cfg():
        return BERSimConfig(sim=SimConfig(SNRdB=snr, Nframes=4096, Nfers=200,
                                          batch_size=256, ber_min=1e-7),
                            ldpc=LDPCConfig(zero_codeword=True))

    codec = LUTCodec.design(graph, 0.85**2, max_iters=50, Nq_Cha=16, Nq_Msg=16)
    failed = []
    for name, kw in (("lut_q4", dict(codec=codec)),
                     ("spa", dict(bp_decoder=BPDecoder(graph, dev, 50, algorithm="spa"))),
                     ("nms", dict(bp_decoder=BPDecoder(graph, dev, 50, algorithm="nms")))):
        t0 = time.perf_counter()
        sim = BERSim(cfg(), graph, dev, **kw)
        qk.reset_launches()
        res = sim.run(seed=0, verbose=False)
        if name == "lut_q4":
            if not isinstance(sim.decoder, HybridLUTDecoder) or sim.decoder.pre.loop != "std":
                raise AssertionError("expected a HybridLUTDecoder on the std loop")
            tab = sim.decoder.pre.tables
            for kname, per_pass in (("cn_std_pass", len(tab.cn_blocks)),
                                    ("vn_std_pass", len(tab.vn_blocks))):
                results[kname]["sim_launches"] = qk.LAUNCHES[kname]
                frames_only(kname, per_pass)
            sim_kernels(sim, 2.0, "phase 18: lut_q4")
        ref = np.load(f"docs/waterfall/{name}.npz")
        rows = []
        for i, s in enumerate(snr):
            n1, f1 = int(res.frames[i]), int(res.frame_errors[i])
            n2, f2 = int(ref["sim_Nframes"][i]), int(ref["sim_frame_errors"][i])
            if n1 and n2:
                z, ok = fer_test(f1, n1, f2, n2)
                if not ok:
                    failed.append(f"{name} {s:g} dB")
                rows.append(f"{s:g} dB {f1}/{n1}={f1 / n1:.3e} vs {f2}/{n2}={f2 / n2:.3e} "
                            f"(z {z:+.2f}{'' if ok else ' FAIL'})")
            else:
                rows.append(f"{s:g} dB frames {n1} / TPU-era {n2}")
        log(f"# phase 18: {name} N=1000 waterfall in {time.perf_counter() - t0:.1f}s "
            f"({res.runtime:.1f}s simulating, {int(res.frames.sum())} frames) on {smi}; "
            f"FER here vs TPU-era: " + "; ".join(rows))
    if failed:
        raise AssertionError(f"waterfall points outside the two-proportion test at "
                             f"alpha = 1e-3: {failed}")


def cli_run(dev, smi):
    """Phase 19: lut_ldpc_torch.cli.ber_sim on params/ber.ini.regular.example
    (10GBase-T (6,32) N=2048, encoded, q4/q3, trees from file, qcha initial
    messages) on the card, its results and its designed codec in a
    temporary directory: the files of the JAX CLI's names, read back by the
    port; the data BER below the uncoded BER wherever the TPU-era curve
    (docs/waterfall/lut_10gbaset_q4q3.npz) has it below, and each point's
    frame errors against that curve at alpha = 1e-3; every pass of the run
    on the CN frames and the generated VN kernel (launch counts set to 0
    before it); then the kernels of the saved codec's decoder at the run's
    batch width against their plain versions (sim_kernels)."""
    import os
    import tempfile

    from lut_ldpc_torch.cli import ber_sim
    from lut_ldpc_torch.decoder import LUTCodec
    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.sim import BERSim, BERSimResults, parse_ini

    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "params", "ber.ini.regular.example")
    with tempfile.TemporaryDirectory() as tmp:
        with open(src) as f:
            text = f.read()
        ini = os.path.join(tmp, "ber.ini.regular.example")
        codec_path = os.path.join(tmp, "codec.npz")
        with open(ini, "w") as f:
            f.write(text.replace("results_dir = results",
                                 f"results_dir = {os.path.join(tmp, 'results')}\n"
                                 f"codec_filename = {codec_path}"))
        t0 = time.perf_counter()
        qk.reset_launches()
        if ber_sim.main(["-p", ini, "-s", "0", "-b", root]) != 0:
            raise AssertionError("ber_sim CLI failed")
        cli_s = time.perf_counter() - t0
        cfg = parse_ini(ini)
        launches = {n: c for n, c in qk.LAUNCHES.items() if c}
        # the decoder the CLI built, from the codec it designed and saved
        codec = LUTCodec.load(codec_path)
        cfg_zero = parse_ini(ini)
        cfg_zero.ldpc.zero_codeword = True
        sim = BERSim(cfg_zero, codec.graph, dev, codec=codec)
        dec = getattr(sim.decoder, "pre", sim.decoder)
        if dec.loop != "std" or dec.tables.max_dc <= qk.MAX_DEGREE:
            raise AssertionError(f"expected the std loop with checks above degree "
                                 f"{qk.MAX_DEGREE}, got {dec.loop}, {dec.tables.max_dc}")
        for kname, per_pass in (("cn_std_pass", len(dec.tables.cn_blocks)),
                                ("vn_std_pass", len(dec.tables.vn_blocks))):
            frames_only(kname, per_pass)
        out_dir = os.path.join(tmp, "results")
        (base,) = os.listdir(out_dir)
        stem = os.path.join(out_dir, base, f"{base}_rseed0000")
        for path in (stem + ".npz", stem + ".it", stem + ".json",
                     os.path.join(out_dir, base, "ber.ini.regular.example")):
            if not os.path.exists(path):
                raise AssertionError(f"CLI did not write {path}")
        res = BERSimResults.load(stem + ".npz")
        it = BERSimResults.load_itfile(stem + ".it")
        if it.frames.tolist() != res.frames.tolist() or base != ber_sim.gen_filename(
                cfg, res.nvar, res.rate):
            raise AssertionError("CLI results: .it and .npz disagree or wrong name")
    ref = BERSimResults.load("docs/waterfall/lut_10gbaset_q4q3.npz")
    rows, bad = [], []
    for i, s in enumerate(res.snr_db):
        if not res.frames[i]:
            rows.append(f"{s:g} dB no frames")
            continue
        z, ok, below = 0.0, True, True  # above the TPU-era curve's last point
        if ref.frames[i]:
            z, ok = fer_test(int(res.frame_errors[i]), int(res.frames[i]),
                             int(ref.frame_errors[i]), int(ref.frames[i]))
            below = ref.ber()[i] < ref.uncoded_ber()[i]
        if not ok or (below and not res.ber()[i] < res.uncoded_ber()[i]):
            bad.append(f"{s:g} dB")
        rows.append(f"{s:g} dB frames {res.frames[i]}, data BER {res.ber()[i]:.3e} "
                    f"(uncoded {res.uncoded_ber()[i]:.3e}), FER {res.fer()[i]:.3e} vs "
                    f"TPU-era {ref.fer()[i]:.3e} (z {z:+.2f})")
    if bad:
        raise AssertionError(f"CLI run off the TPU-era curve at {bad}")
    log(f"# phase 19: ber_sim CLI on params/ber.ini.regular.example in {cli_s:.1f}s "
        f"(N={res.nvar}, rate {res.rate:g}, check degrees "
        f"{sorted(b.degree for b in dec.tables.cn_blocks)}): {base}_rseed0000.npz, .it, "
        f".json and the params copy written and read back; launches {launches}; "
        + "; ".join(rows) + f" on {smi}")
    sim_kernels(sim, 4.5, "phase 19: 10GBase-T")


def de_launches(tde, v2c, cha, iters):
    """Kernels the eager loop body launches an iteration (torch.profiler over
    `iters` eager iterations): device kernels seen, and the runtime's
    cudaLaunchKernel calls; None where the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    maxiter, graph = tde.maxiter_de, tde.graph
    tde.maxiter_de, tde.graph = iters, False
    try:
        tde.evolve(v2c, cha)  # warm-up: masks, tables, plans
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tde.evolve(v2c, cha)
            torch.cuda.synchronize()
    finally:
        tde.maxiter_de, tde.graph = maxiter, graph
    events = list(prof.events())
    kernels = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    launches = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                    "cudaLaunchKernelExC"))
    return (kernels / iters or None), (launches / iters or None)


def timed_evolve(tde, v2c, cha):
    """(outputs as numpy, seconds, iterations) of one evolve on the card."""
    import torch

    tde.stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tde.evolve(v2c, cha) if cha is not None else tde.evolve(v2c)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return [t.cpu().numpy() for t in out], dt, tde.stats.iterations


def same_outputs(a, b, what):
    import numpy as np

    for x, y in zip(a, b):
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: outputs differ ({x} vs {y})")


def de_explorers(dev, smi):
    """Phase 20: the batched DE explorers (torch ops; no hand-written
    kernel) and the de_sim / reuse_vec_opt CLIs on the card."""
    import os
    import tempfile

    import numpy as np
    import torch

    from lut_ldpc_torch.core.ensemble import LDPCEnsemble
    from lut_ldpc_torch.design import DEBpGPU, DELutGPU

    # 20a: the published design point at full size
    irr = LDPCEnsemble.read("ensembles/rate0.50_dv02-17_dc08-09_lut_q4.ens")
    kw = dict(maxiter_de=2000, Pe_max=1e-6, max_ni_de_iters=30, strategy="joint_root",
              tree_mode="auto_bin_balanced")
    tde = DELutGPU(irr, 16, 16, device=dev, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    thr = tde.threshold(points=9, rounds=3)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    rounds = list(tde.stats.loops)
    if abs(thr - 0.929193) > 2e-3:
        raise AssertionError(f"phase 20a: DE-LUT threshold {thr} not within 2e-3 of 0.929193")
    # ms per DE iteration on the threshold's last grid, graph and eager
    step = (tde.thr_max - tde.thr_min) / 8**2
    grid = np.linspace(thr - step / 2, thr + step / 2, 9)
    v2c, cha = tde.channel_pmfs(grid)
    out_g, dt_g, n_g = timed_evolve(tde, v2c, cha)
    tde.graph = False
    out_e, dt_e, n_e = timed_evolve(tde, v2c, cha)
    tde.graph = True
    same_outputs(out_g, out_e, "phase 20a: CUDA graph against the eager loop")
    kernels, launches = de_launches(tde, v2c, cha, 10)
    log(f"# phase 20a: DE-LUT irregular q4 joint_root (VN 2/3/9/17, CN 8/9), "
        f"threshold(points=9, rounds=3) = {thr:.6f} (published 0.929193, "
        f"diff {thr - 0.929193:+.6f}) in {wall:.3f} s wall; DE iterations per round "
        f"{rounds}; peak device memory {peak:.3f} GiB; on the last grid ({n_g} iterations): "
        f"{dt_g / n_g * 1e3:.4f} ms per DE iteration with the CUDA graph, "
        f"{dt_e / n_e * 1e3:.4f} eager (outputs equal); kernels per eager iteration "
        f"{kernels} (profiler), cudaLaunchKernel calls {launches}; one graph launch an "
        f"iteration with the graph; on {smi}")

    # 20b: the card against the CPU and against itself, first grid round
    def first_round(make, ref_thr, what, args):
        gpu, cpu = make(dev), make("cpu")
        grid = np.linspace(*args, 9)
        outs = []
        for _ in range(2):
            if isinstance(gpu, DELutGPU):
                outs.append(timed_evolve(gpu, *gpu.channel_pmfs(grid)))
            else:
                outs.append(timed_evolve(gpu, gpu.channel_pmfs(grid), None))
        same_outputs(outs[0][0], outs[1][0], f"phase 20b: {what}: two card runs")
        t0 = time.perf_counter()
        if isinstance(cpu, DELutGPU):
            ach_c, Pe_c, _ = (t.numpy() for t in cpu.evolve(*cpu.channel_pmfs(grid)))
        else:
            ach_c, Pe_c, _ = (t.numpy() for t in cpu.evolve(cpu.channel_pmfs(grid)))
        cpu_s = time.perf_counter() - t0
        ach, Pe = outs[0][0][0], outs[0][0][1]
        far = np.abs(grid - ref_thr) > 0.01
        if not np.array_equal(ach[far], ach_c[far]):
            raise AssertionError(f"phase 20b: {what}: card decisions {ach} against CPU {ach_c}")
        rel = float(np.max(np.abs(Pe - Pe_c) / np.maximum(np.abs(Pe_c), 1e-30)))
        log(f"# phase 20b: {what}: first grid round ({outs[0][2]} iterations) twice on the "
            f"card, array_equal; {outs[0][1] * 1e3:.3f} ms on the card, {cpu_s:.3f} s on the "
            f"CPU; decisions equal at the {int(far.sum())} points more than 0.01 from the "
            f"threshold ({ach.astype(int).tolist()} / {ach_c.astype(int).tolist()}); largest "
            f"relative Pe difference {rel:.3e}; on {smi}")

    kw400 = dict(kw, maxiter_de=400)
    first_round(lambda d: DELutGPU(irr, 16, 16, device=d, **kw400), thr,
                "DE-LUT irregular q4, maxiter_de=400", (tde.thr_min, tde.thr_max))
    ens36 = LDPCEnsemble(np.array([3]), np.array([1.0]), np.array([6]), np.array([1.0]))
    bkw = dict(Nb=9, maxiter_de=1000, Pe_max=1e-6)
    bp = DEBpGPU(ens36, device=dev, **bkw)
    bp.stats.reset()
    t0 = time.perf_counter()
    thr_bp = bp.threshold(points=9, rounds=3)
    bp_wall = time.perf_counter() - t0
    bp_rounds = list(bp.stats.loops)
    if abs(thr_bp - 0.88046) > 3e-3:
        raise AssertionError(f"phase 20b: DE-BP threshold {thr_bp} not within 3e-3 of 0.88046")
    pmf = bp.channel_pmfs(np.linspace(thr_bp - 0.004, thr_bp + 0.004, 9))
    out_g, dt_g, n_g = timed_evolve(bp, pmf, None)
    bp.graph = False
    out_e, dt_e, n_e = timed_evolve(bp, pmf, None)
    bp.graph = True
    same_outputs(out_g, out_e, "phase 20b: DE-BP CUDA graph against the eager loop")
    log(f"# phase 20b: DE-BP (3,6) Nb=9 threshold(points=9, rounds=3) = {thr_bp:.6f} "
        f"(pinned 0.88046) in {bp_wall:.3f} s, DE iterations per round {bp_rounds}; "
        f"near the threshold ({n_g} iterations) {dt_g / n_g * 1e3:.4f} ms per DE iteration "
        f"with the CUDA graph, {dt_e / n_e * 1e3:.4f} eager (outputs equal); on {smi}")
    first_round(lambda d: DEBpGPU(ens36, device=d, **bkw), thr_bp,
                "DE-BP (3,6) Nb=9, maxiter_de=1000", (bp.host.thr_min, bp.host.thr_max))

    # 20c: reuse pre-ranking, every single-reuse candidate of the first
    # round of reuse_vec_opt (cli/reuse_vec_opt.py: 99 rows at 100 iterations)
    M = 100
    rm = np.zeros((M - 1, M), bool)
    rm[np.arange(M - 1), np.arange(1, M)] = True
    for pmax, gate in ((1e-4, True), (1e-6, False)):
        ranks = []
        for d in (dev, "cpu"):
            acc = DELutGPU(ens36, 16, 16, maxiter_de=M, Pe_max=pmax, max_ni_de_iters=1,
                           device=d)
            Pe, it_hit = acc.prerank_reuse(0.82, rm, pmax)
            ranks.append(np.argsort(Pe, kind="stable")[:10])
            if d == dev:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                again = acc.prerank_reuse(0.82, rm, pmax)
                call_ms = (time.perf_counter() - t0) * 1e3
                same_outputs((Pe, it_hit), again, "phase 20c: two card runs")
        agree = int((ranks[0] == ranks[1]).sum())
        if gate and agree != 10:
            raise AssertionError(f"phase 20c: top 10 {ranks[0]} on the card, {ranks[1]} on "
                                 f"the CPU")
        log(f"# phase 20c: prerank_reuse sigma 0.82, (3,6) q4 min-LUT, 99 candidates x "
            f"{M} iterations, pmax {pmax:g}: {call_ms:.3f} ms a call on the card; top 10 "
            f"{ranks[0].tolist()}, {agree} of 10 places equal to the CPU's"
            + ("" if gate else " (f32 noise regime, ROADMAP C12: not held)") + f"; on {smi}")

    # 20d: the CLIs on the card, in processes of their own
    with tempfile.TemporaryDirectory() as tmp:
        thrs, secs = [], []
        for accel in (1, 0):
            ini = os.path.join(tmp, f"de{accel}.ini")
            report = os.path.join(tmp, f"report{accel}.txt")
            with open(ini, "w") as f:
                f.write("[Sim]\nensemble_filename = ensembles/rate0.50_dv03_dc06.ens\n"
                        f"maxiter_de = 200\nthr_prec = 1e-4\naccelerator_sweep = {accel}\n"
                        f"results_name = {report}\n[LUT]\nqbits = 4 4\nmin_lut = true\n")
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m", "lut_ldpc_torch.cli.de_sim", "-p", ini],
                           check=True, capture_output=True, text=True, timeout=600)
            secs.append(time.perf_counter() - t0)
            with open(report) as f:
                txt = f.read()
            thrs.append(float(txt.split("Threshold(s) found = [")[1].split("]")[0]))
        if abs(thrs[0] - thrs[1]) > 1e-4:
            raise AssertionError(f"phase 20d: de_sim thresholds {thrs} differ by more "
                                 f"than thr_prec")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "lut_ldpc_torch.cli.reuse_vec_opt", "-m", "-t", "0.82",
             "-i", "30", "-r", "10", "-p", "1e-6", "-d", "3 / 1.0 / 6 / 1.0", "--accel", "8"],
            check=True, capture_output=True, text=True, timeout=600).stdout
        reuse_s = time.perf_counter() - t0
        lines = out.strip().splitlines()
        if "Finished." not in lines:
            raise AssertionError(f"phase 20d: reuse_vec_opt did not finish: {lines[-3:]}")
    log(f"# phase 20d: de_sim (3,6) q4 min-LUT, 200 iterations, thr_prec 1e-4: threshold "
        f"{thrs[0]:.6f} with accelerator_sweep = 1 in {secs[0]:.2f} s, {thrs[1]:.6f} with "
        f"accelerator_sweep = 0 in {secs[1]:.2f} s; reuse_vec_opt --accel 8 (30 iterations, "
        f"10 stages) in {reuse_s:.2f} s: {lines[-1]}; on {smi}")


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
        head_dec, head_lc, head_lm, head_mbits, head_iters = headline(
            dev, smi, head_codec, results, launches)
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
        del dvb_lc, dvb_lm
        torch.cuda.empty_cache()
        # phases 16, 18 and 19 run while the golden workers finish
        for phase, run in ((16, lambda: bp_baselines(dev, smi, head_codec)),
                           (18, lambda: waterfall(dev, smi, results)),
                           (19, lambda: cli_run(dev, smi))):
            t0 = time.perf_counter()
            run()
            torch.cuda.empty_cache()
            log(f"# phase {phase} took {time.perf_counter() - t0:.1f}s")
        check_worker_golden("PEG", golden, peg_frame0, codec.max_iters)
        check_worker_golden("DVB-S2", golden_dvb, dvb_frame0, codec.max_iters)
    # the workers have ended: the simulator's step is timed on a quiet host
    t0 = time.perf_counter()
    sim_step(dev, smi, head_codec, head_mbits, head_iters, results)
    log(f"# phase 17 took {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    de_explorers(dev, smi)
    log(f"# phase 20 took {time.perf_counter() - t0:.1f}s")

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
