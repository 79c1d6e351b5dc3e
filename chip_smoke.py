"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints; any failure raises and exits non-zero):
 1. the card (nvidia-smi name and power limit), torch and CUDA versions;
 2. design the headline, the N=64800 PEG and the two DVB-S2 codecs (and
    load the two stored thr-0.67 codecs of phase 22), and
    meanwhile build every CUDA library side by side, one nvcc each: the
    kernel library's four units (the CN frames of csrc/cn_frames.cuh for
    int16 and for float32 messages, csrc/qc_kernels.cu: the CN block
    kernel and the table-driven witnesses, and csrc/loop_glue.cu: the
    value-domain loop's glue), one generated VN unit per
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
18. the N=1000 PEG (3,6) waterfall through
    lut_ldpc_torch.examples.ber_waterfall (q4 min-LUT on the std kernels,
    spa, nms), every point's frame errors against the TPU-era
    docs/waterfall/{lut_q4,spa,nms}.npz (two-sided two-proportion test,
    alpha = 1e-3), the LUT run's launches; then the
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
    reuse_vec_opt --accel 8, each in a process of its own;
21. after phase 20, the data-parallel mesh (lut_ldpc_torch/parallel), the
    entry points and PEG: (a) phase 17's simulator step (zero codeword,
    B=8192, 2 dB, 6 batches) over two slots on cuda:0, the seven counters
    equal to the unmeshed run's, the QC pair launched with no witness
    (launch counts set to 0 just before the meshed run); then at 1.5 dB
    an Nfers stop after an odd number of batches (the group's surplus
    batch dropped), equal on one and two slots; (b) the same 2 dB run in
    two spawned processes of one slot each on cuda:0 joined by gloo, each
    loading the headline codec from the file phase 2 saved, its counters
    equal to (a)'s, no library built (the ranks find phase 2's on disk),
    a timeout on the ranks; (c) DELutGPU on the (3,6) ensemble over two
    slots: evolve_batch at 11 points and prerank_reuse at 5 rows
    array_equal to the unmeshed explorer on the card; (d) entry("cuda")
    decodes as entry("cpu"), and dryrun_multichip(2) on ["cuda:0"] * 2
    passes its kernel-path check; (e) peg_gen (3,6) N=1000 through the
    port's native library.  It prints a `mesh` JSON line: the counters of
    each run, ms a batch on one slot, on two slots sharing the card and in
    two processes, and the seconds of each part;
22. after phase 21, the DVB-S2-scale waterfalls (BASELINE.json config 4)
    and BASELINE config 2 through the port's example workflows
    (lut_ldpc_torch/examples), B=2048, the codecs of phase 2 (thr 0.90, 50
    iterations) and those it designs beside them: (a) dvbs2_waterfall's
    lut64800 (PEG N=64800, 0.8:0.2:1.6 dB, Nframes 16384, Nfers 200,
    ber_min 1e-8) held against docs/waterfall/lut_dv02-17_N64800_q4.npz,
    then one 1.2 dB batch at B and at B - 3 (one frame a thread): the
    B - 3 frames equal to the full batch's, both timed; (b) lut64800_qc
    (the QC code of the same ensemble), printed beside (a) with the z of
    each point, not held; (c) dvbs2_spa (BP spa, 50 iterations, on the
    DVB-S2 alist, 0.6:0.2:1.4 dB, Nframes 2048) against
    dvbs2_N64800_spa.npz; (d) dvbs2_qc_equivalence's run() on both
    realizations (0.8-1.4 dB, 8192 frames a point, skipping off), each
    against its part of dvbs2_qc_equivalence.json and the QC realization
    against the gather one; (e) run_dvbs2_lut with the stored thr-0.67
    codec (1.5-1.8 dB, 8192 frames a point, skipping off) against
    dvbs2_N64800_lut_q4.json, its stability numbers equal to the file's;
    (g) the same with the stored QC codec on the matrix's Z=360 realization
    (dvbs2_lut_qc: load_periodic_alist, one phantom edge) against the same
    file (the same matrix), on the loop the JAX package takes for that codec
    (std: a codec file keeps no QC structure), no pass of another pair;
    (f) the ber_sim CLI on params/ber.ini.irregular.example (results and
    codec sent to a temporary directory) against
    lut_irregular_N500_q4.json.  Every held point passes fer_test (alpha =
    1e-3) or the script fails.  Each run prints frames, frame errors and
    FER per point, mean iterations, frames/s, Mbit/s (frames x k /
    runtime), peak device memory, the decoder class, the passes of the six
    kernels (launch counts set to 0 just before the run; the block pair
    must be 0, no pass on a witness) and the class launches at one frame a
    thread; then each value-domain segment's CN frames and VN kernel
    against their plain versions at the run's widths (B, B/4 where the
    funnel narrows, each also 3 frames fewer);
23. after phase 22, the port's regression ledger
    (lut_ldpc_torch.tools.perf_regress): `record` twice into a temporary
    ledger with phase 2's codecs (the fused CN + VN chains at N=10000 and
    N=64800, the headline, DVB-S2 and PEG decodes, a fresh headline decoder
    built with its generated VN units compiled cold and its first two
    calls, the kernel library's units built cold into a temporary
    directory), each entry printed; `check` must return 0 on the two and 1
    once a third record with the headline decode 1.5 times slower is
    appended; every pass on the CN frames or the generated VN kernels, none
    on a table-driven witness (qc_kernels.WITNESS_LAUNCHES), no block
    kernel.  Then the kernels at the records' shapes against their plain
    versions: both fused chains on their own inputs (one CN pass, one and
    all chained iterations), and the CN frames and generated VN kernels of
    the N=64800 QC, DVB-S2 and PEG decoders at B=1024 and 1021;
24. after phase 23, the value-domain loop's glue (csrc/loop_glue.cu:
    loop_state_kernel, latch_kernel, init_values_kernel): each against its
    plain version, max_abs_err 0, at the headline (QC int16 and the block
    loop, B=8192 and 8189), DVB-S2 (QC float32 with its phantom, 4096 /
    4093) and PEG std (int16, 2048 / 2045) shapes, with times, plain times,
    bounds and the latch's torch.where, the latch with no frame converging
    and the VN pass beside it; then the headline,
    headline block-loop, DVB-S2 and PEG decodes each with the launch counts
    set to 0 just before (every glue kernel of its path launched, the first
    256 frames equal to the plain twin's), the headline's time and one
    traced headline decode (busy, passes, glue, idle share, glue kernels).
Every main-path decode (phases 4, 8, 11, 13, 14, 17, 18, 19, 21, 22, 23) must have run each
CN and VN pass on the CN frames, the CN block kernel or the generated VN
kernels, none on a table-driven witness.  Then a JSON line of per-kernel results
(time, plain twin's time, the card's bound for the same work; `launches`
counts the wrapper's calls on the main path (one a pass; one a degree block
for `cn_block_pass`), `class_launches` the kernel launches these made, one
a degree class, block or run of block-rows; the rows of the CN frames and
of the generated VN kernels also carry `witness_ms`, the table-driven
kernel's time, and `cn_std_pass` `unfolded_ms`; the QC pair's
`sim_launches` are the passes of phase 17's simulator run and
`mesh_launches` those of phase 21a's meshed run, the std pair's
`sim_launches` those of phase 18's LUT run; `example_launches` the passes
of phase 22's runs and `example_one_frame_launches` their class launches
at one frame a thread, `regress_launches` the passes of phase 23; the glue
rows of phase 24 have `launches` from its four main-path decodes and their
times at the first shapes they were timed at (`shapes`; the latch's
`idle_ms` with no frame converging)), the card, and last the device line.
"""

import json
import os
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


GLUE_SOURCE = "lut_ldpc_torch/csrc/loop_glue.cu"  # the loop's state, latch and init
# the value-domain loop's glue (phase 24): no TPU kernel computed it; each
# replaces the JAX loop's glue at the line given
GLUE_REPLACES = {"loop_state": "lut_ldpc_tpu/decoder/arith_decoder.py:1285",
                 "latch": "lut_ldpc_tpu/decoder/arith_decoder.py:1286",
                 "init_values": "lut_ldpc_tpu/decoder/arith_decoder.py:1253"}

ROOT = os.path.dirname(os.path.abspath(__file__))
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
    if got != want or want < 1 or qk.WITNESS_LAUNCHES[name]:
        raise AssertionError(f"{name}: {got} class launches in "
                             f"{qk.LAUNCHES[name]} passes, expected {want}; "
                             f"{qk.WITNESS_LAUNCHES[name]} on the table-driven kernel")
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
    """Phase 18: the N=1000 PEG (3,6) waterfall through
    lut_ldpc_torch.examples.ber_waterfall.run_waterfall (SNR 1.0:0.25:3.5 dB,
    Nframes 4096, Nfers 200, batch 256, zero codeword, seed 0, ber_min 1e-7;
    its files in a temporary directory) for the q4 min-LUT codec (thr 0.85),
    spa and nms (50 iterations each), each point's frame errors held against
    the TPU-era docs/waterfall/{lut_q4,spa,nms}.npz by a two-sided
    two-proportion test at alpha = 1e-3."""
    import tempfile

    from lut_ldpc_torch.decoder import HybridLUTDecoder
    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.examples import ber_waterfall
    from lut_ldpc_torch.sim import BERSimResults

    qk.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        runs = ber_waterfall.run_waterfall(tmp, frames=4096, batch=256, device=dev)
        written = sorted(os.listdir(tmp))
    log(f"# phase 18: ber_waterfall.run_waterfall in {time.perf_counter() - t0:.1f}s wrote "
        f"{', '.join(written)}")
    for name, _, res, sim in runs:
        if name == "lut_q4":
            # the BP runs launch no LUT kernel: the counts are the LUT run's
            if not isinstance(sim.decoder, HybridLUTDecoder) or sim.decoder.pre.loop != "std":
                raise AssertionError("expected a HybridLUTDecoder on the std loop")
            tab = sim.decoder.pre.tables
            for kname, per_pass in (("cn_std_pass", len(tab.cn_blocks)),
                                    ("vn_std_pass", len(tab.vn_blocks))):
                results[kname]["sim_launches"] = qk.LAUNCHES[kname]
                frames_only(kname, per_pass)
            sim_kernels(sim, 2.0, "phase 18: lut_q4")
        ref = BERSimResults.load(os.path.join(ROOT, "docs", "waterfall", f"{name}.npz"))
        log(f"# phase 18: {name} N=1000 waterfall ({res.runtime:.1f}s simulating, "
            f"{int(res.frames.sum())} frames) on {smi}; FER here vs TPU-era: "
            + curve_rows(res, ref.frames, ref.frame_errors, f"phase 18 {name}"))


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


def mesh_rank(rank, port, codec_path, out_path):
    """Phase 21b, one of two spawned processes: a gloo group on localhost,
    one slot on cuda:0 a rank, the headline codec from phase 2's file, and
    the meshed simulator run of 21a."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from lut_ldpc_torch.decoder import codec_from_arrays
    from lut_ldpc_torch.parallel import dp_mesh
    from lut_ldpc_torch.sim import BERSim

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        with np.load(codec_path) as z:
            codec = codec_from_arrays(dict(z))
        mesh = dp_mesh(devices=["cuda:0"])
        sim = BERSim(mesh_config(), codec.graph, codec=codec, mesh=mesh)
        t0 = time.perf_counter()
        res = sim.run(seed=0, verbose=False)
        torch.cuda.synchronize()
        out = dict(counters=counters_of(res), run_s=time.perf_counter() - t0)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def mesh_config(snr_db=2.0, batches=6, nfers=10**9):
    import numpy as np

    from lut_ldpc_torch import bench
    from lut_ldpc_torch.sim import BERSimConfig, LDPCConfig, SimConfig

    B = bench.BATCH
    return BERSimConfig(sim=SimConfig(SNRdB=np.array([snr_db]), Nframes=batches * B,
                                      Nfers=nfers, batch_size=B),
                        ldpc=LDPCConfig(zero_codeword=True))


def counters_of(res):
    return {name: int(getattr(res, name)[0]) for name in
            ("frames", "data_bits", "uncoded_bits", "frame_errors", "data_bit_errors",
             "uncoded_bit_errors", "decode_iters")}


def mesh_phase(dev, smi, codec, codec_path, results):
    """Phase 21: the data-parallel mesh (a, b), the DE explorer over two
    slots (c), the entry points (d) and PEG (e).  Returns the mesh line."""
    import multiprocessing
    import os
    import socket
    import tempfile

    import numpy as np
    import torch

    from lut_ldpc_torch import _native, bench, entry
    from lut_ldpc_torch.cli import peg_gen
    from lut_ldpc_torch.core.ensemble import LDPCEnsemble
    from lut_ldpc_torch.decoder import HybridLUTDecoder
    from lut_ldpc_torch.decoder import nvcc
    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.design import DELutGPU
    from lut_ldpc_torch.ops.pmf import snr2sig
    from lut_ldpc_torch.parallel import dp_mesh
    from lut_ldpc_torch.sim import BERSim

    B, nb, secs, runs = bench.BATCH, 6, {}, {}
    two = dp_mesh(devices=["cuda:0"] * 2)

    def timed_run(sim, seed=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run(seed=seed, verbose=False)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # 21a: the headline simulator step over two slots on the card
    t0 = time.perf_counter()
    one = BERSim(mesh_config(), codec.graph, dev, codec=codec)
    meshed = BERSim(mesh_config(), codec.graph, codec=codec, mesh=two)
    for sim in (one, meshed):
        if not isinstance(sim.decoder, HybridLUTDecoder) or sim.decoder.S != 32:
            raise AssertionError(f"21a: expected the headline HybridLUTDecoder, got "
                                 f"{type(sim.decoder).__name__}")
    one.config.sim.Nframes = meshed.config.sim.Nframes = 2 * B  # warm-up
    one.run(seed=9, verbose=False)
    meshed.run(seed=9, verbose=False)
    one.config.sim.Nframes = meshed.config.sim.Nframes = nb * B
    res1, s1 = timed_run(one)
    qk.reset_launches()
    res2, s2 = timed_run(meshed)
    tab = meshed.decoder.pre.tables
    for name, per_pass in (("cn_qc_pass", len(tab.cn_runs)), ("vn_qc_pass", len(tab.vn_runs))):
        results[name]["mesh_launches"] = qk.LAUNCHES[name]
        frames_only(name, per_pass)
    runs["one_slot"], runs["two_slots"] = counters_of(res1), counters_of(res2)
    if runs["one_slot"] != runs["two_slots"] or runs["one_slot"]["frames"] != nb * B:
        raise AssertionError(f"21a: two slots {runs['two_slots']} against one slot "
                             f"{runs['one_slot']}")
    # an Nfers stop inside a group: at 1.5 dB, the first even batch index
    # j >= 2 with frame errors; Nfers = the errors of batches 0 .. j-1, so
    # the run counts j + 1 (odd) batches and drops batch j + 1 of its group
    sigma = torch.tensor(float(snr2sig(one.rate, 1.5)), dtype=torch.float32, device=dev)
    fe = [one.step(0, 0, bb, sigma)["frame_errors"] for bb in range(nb)]
    stops = [j for j in range(2, nb, 2) if fe[j] > 0]
    if not stops:
        raise AssertionError(f"21a: no frame errors at an even batch index at 1.5 dB: {fe}")
    j = stops[0]
    nfers = sum(fe[:j])
    stop_one = BERSim(mesh_config(1.5, nb, nfers), codec.graph, dev, codec=codec)
    stop_two = BERSim(mesh_config(1.5, nb, nfers), codec.graph, codec=codec, mesh=two)
    r_one, r_two = (counters_of(s.run(seed=0, verbose=False)) for s in (stop_one, stop_two))
    runs["stop_one_slot"], runs["stop_two_slots"] = r_one, r_two
    if r_one != r_two or r_one["frames"] != (j + 1) * B:
        raise AssertionError(f"21a: Nfers {nfers} stop: two slots {r_two}, one slot {r_one}, "
                             f"expected {j + 1} batches")
    secs["a"] = time.perf_counter() - t0
    del one, meshed, stop_one, stop_two
    torch.cuda.empty_cache()
    log(f"# phase 21a: BERSim B={B}, 2 dB, {nb} batches: one slot {s1 * 1e3 / nb:.3f} ms a "
        f"batch, two slots on cuda:0 {s2 * 1e3 / nb:.3f} ms a batch, counters equal "
        f"{runs['one_slot']}; QC launches of the meshed run "
        f"{ {n: c for n, c in qk.LAUNCHES.items() if c} }; 1.5 dB Nfers {nfers} stop after "
        f"{j + 1} batches (frame errors a batch {fe}) equal on one and two slots; "
        f"{secs['a']:.1f}s on {smi}")

    # 21b: the same run over two processes of one slot each (gloo)
    t0 = time.perf_counter()
    libs = sorted(os.listdir(nvcc.BUILD_DIR))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    tmp = tempfile.mkdtemp()
    out_path = os.path.join(tmp, "rank0.json")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(r, port, codec_path, out_path))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=240)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"21b: the ranks exited with {codes}")
    with open(out_path) as f:
        got = json.load(f)
    runs["two_processes"] = got["counters"]
    if got["counters"] != runs["two_slots"]:
        raise AssertionError(f"21b: two processes {got['counters']} against two slots "
                             f"{runs['two_slots']}")
    if sorted(os.listdir(nvcc.BUILD_DIR)) != libs:
        raise AssertionError("21b: the ranks built a library instead of reusing phase 2's")
    secs["b"] = time.perf_counter() - t0
    log(f"# phase 21b: two processes on cuda:0 (gloo), the headline codec from phase 2's "
        f"file: counters equal 21a's; rank 0's run {got['run_s']:.2f}s "
        f"({got['run_s'] * 1e3 / nb:.3f} ms a batch), no library built; {secs['b']:.1f}s")

    # 21c: the DE explorer over two slots, the JAX mesh tests' shapes
    t0 = time.perf_counter()
    ens = LDPCEnsemble(np.array([3]), np.array([1.0]), np.array([6]), np.array([1.0]))
    kw = dict(Pe_max=1e-6, max_ni_de_iters=30)
    sig = np.linspace(0.80, 0.92, 11)
    a1 = DELutGPU(ens, maxiter_de=60, device=dev, **kw).evolve_batch(sig)
    a2 = DELutGPU(ens, maxiter_de=60, mesh=two, **kw).evolve_batch(sig)
    M = 12
    reuse = np.zeros((5, M), dtype=bool)
    for i in range(1, 5):
        reuse[i, 2 * i] = True
    p1 = DELutGPU(ens, maxiter_de=M, device=dev, **kw).prerank_reuse(0.85, reuse)
    p2 = DELutGPU(ens, maxiter_de=M, mesh=two, **kw).prerank_reuse(0.85, reuse)
    for what, x, y in (("evolve_batch", a1, a2), ("prerank_reuse", p1, p2)):
        if not all(np.array_equal(u, v) for u, v in zip(x, y)):
            raise AssertionError(f"21c: {what} over two slots {y} against unmeshed {x}")
    secs["c"] = time.perf_counter() - t0
    log(f"# phase 21c: DELutGPU (3,6) q4 over two slots on cuda:0: evolve_batch at 11 "
        f"points (decisions {a2[0].astype(int).tolist()}) and prerank_reuse at 5 rows "
        f"(it_hit {p2[1].tolist()}) array_equal to the unmeshed explorer; {secs['c']:.1f}s")

    # 21d: the entry points
    t0 = time.perf_counter()
    dec, args = entry.entry(dev)
    out = dec(*args)
    dec_c, args_c = entry.entry("cpu")
    same(tuple(o.cpu() for o in out), dec_c(*args_c), "21d: entry on the card and the CPU")
    entry.dryrun_multichip(2, "cuda", devices=["cuda:0"] * 2)
    secs["d"] = time.perf_counter() - t0
    log(f"# phase 21d: entry('cuda') decodes as on the CPU (ok {float(out[1].float().mean())}"
        f"); dryrun_multichip(2) on ['cuda:0'] * 2 passed; {secs['d']:.1f}s")

    # 21e: PEG through the port's native library
    t0 = time.perf_counter()
    lib = _native.get_lib()
    if lib is None or not hasattr(lib, "peg_construct"):
        raise AssertionError("21e: the native PEG library did not build")
    alist = os.path.join(tmp, "peg1000.alist")
    if peg_gen.main(["500", "1000", alist, "ensembles/rate0.50_dv03_dc06.ens"]) != 0:
        raise AssertionError("21e: peg_gen failed")
    secs["e"] = time.perf_counter() - t0
    log(f"# phase 21e: peg_gen (3,6) N=1000 through {os.path.basename(lib._name)}; "
        f"{secs['e']:.1f}s")
    return dict(counters=runs, ms_per_batch=dict(one_slot=s1 * 1e3 / nb,
                                                 two_slots_one_card=s2 * 1e3 / nb,
                                                 two_processes_one_card=got["run_s"] * 1e3 / nb),
                seconds=secs, card=smi)


def segments(decoder):
    """The value-domain segments of a simulator's decoder (under a
    ChunkedDecoder): [(ArithLUTDecoder, first iteration it runs)], the int16
    prefix first."""
    d = getattr(decoder, "inner", decoder)
    if getattr(d, "pre", None) is None:
        return [(d, 0)]
    later = [(seg, d.pre.S) for seg in (getattr(d, "mid", None), getattr(d, "fin", None))
             if seg is not None]
    return [(d.pre, 0)] + later


def run_launches(decoder, what, example_launches):
    """After a run with the counts set to 0 before it: every pass of the
    decoder's loop went through the CN frames and the generated VN kernels,
    none through a witness, no block kernel ran; adds the run's passes to
    example_launches.  Returns the log text of the six kernels' passes and
    their one-frame-a-thread launches."""
    from lut_ldpc_torch.decoder import qc_kernels as qk

    seg = segments(decoder)[0][0]
    tab = seg.tables
    per_pass = ((len(tab.cn_runs), len(tab.vn_runs)) if seg.loop == "qc" else
                (len(tab.cn_blocks), len(tab.vn_blocks)))
    for name, n in zip(LOOP_PAIRS[seg.loop], per_pass):
        frames_only(name, n)
    if qk.LAUNCHES["cn_block_pass"] or qk.LAUNCHES["vn_block_pass"]:
        raise AssertionError(f"{what}: the block loop ran ({dict(qk.LAUNCHES)})")
    for name in REPLACES:
        example_launches[name][0] += qk.LAUNCHES[name]
        example_launches[name][1] += qk.ONE_FRAME_LAUNCHES[name]
    return ("passes " + ", ".join(f"{n} {qk.LAUNCHES[n]}" for n in REPLACES)
            + "; one frame a thread " + ", ".join(
                f"{n} {qk.ONE_FRAME_LAUNCHES[n]}/{qk.CLASS_LAUNCHES[n]}" for n in REPLACES
                if qk.CLASS_LAUNCHES[n]))


def hold_segments(decoder, widths, what, results):
    """Each segment's CN frames and generated VN kernel at each width the run
    gave them (and 3 frames fewer), on an iteration the segment runs,
    against their plain versions and the table-driven kernels (times not
    held); the largest difference goes into the kernels line."""
    for seg, start in segments(decoder):
        it = (start + seg.spec.num_iters) // 2
        for B in widths:
            for name, r in kernel_vs_twin(seg, it, 1, B, f"{what} {seg.dtype} it={it}",
                                          hold_speed=False).items():
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                                   r["max_abs_err"])


def curve_rows(res, ref_frames, ref_errors, what, hold=True):
    """Per point frames, frame errors and FER against a TPU-era curve (or
    another run) with the two-proportion z; raises where a held point falls
    outside alpha = 1e-3.  Returns the log text."""
    rows, bad, zs = [], [], []
    for i, s in enumerate(res.snr_db):
        n1, f1 = int(res.frames[i]), int(res.frame_errors[i])
        if not n1:
            rows.append(f"{s:g} dB skipped")
            continue
        n2 = int(ref_frames[i]) if i < len(ref_frames) else 0
        if not n2:
            rows.append(f"{s:g} dB {f1}/{n1}={f1 / n1:.3e} (no reference point)")
            continue
        f2 = int(ref_errors[i])
        z, ok = fer_test(f1, n1, f2, n2)
        zs.append(abs(z))
        if hold and not ok:
            bad.append(f"{s:g} dB")
        rows.append(f"{s:g} dB {f1}/{n1}={f1 / n1:.3e} vs {f2}/{n2}={f2 / n2:.3e} "
                    f"(z {z:+.2f}{'' if ok else ' FAIL' if hold else ' not held'})")
    if bad:
        raise AssertionError(f"{what}: points outside the two-proportion test at "
                             f"alpha = 1e-3: {bad}")
    return "; ".join(rows) + (f" (largest |z| {max(zs):.2f})" if zs else "")


def run_summary(res, sim, peak, label):
    """Mean iterations, frames/s, decoded information Mbit/s (frames x k /
    runtime), peak device memory and the decoder class of a run."""
    frames = int(res.frames.sum())
    iters = float(res.decode_iters.sum() / frames)
    dec = type(sim.decoder).__name__
    inner = getattr(sim.decoder, "inner", None)
    if inner is not None:
        dec += f"({type(inner).__name__}, chunk {sim.decoder.chunk})"
    return (f"{label}: {frames} frames in {res.runtime:.2f}s, mean iters {iters:.4f}, "
            f"{frames / res.runtime:.1f} frames/s, {frames * sim.k / res.runtime / 1e6:.3f} "
            f"Mbit/s, peak device memory {peak:.2f} GiB, decoder {dec}")


def monte_carlo(run, what, example_launches, lut=True):
    """Calls run() -> (results, simulator) with the launch counts set to 0
    and the peak memory reset just before it; returns (results, simulator,
    peak GiB, the launches' log text)."""
    import torch

    from lut_ldpc_torch.decoder import qc_kernels as qk

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qk.reset_launches()
    res, sim = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not lut:
        if any(qk.LAUNCHES.values()):
            raise AssertionError(f"{what}: a LUT kernel ran in a BP run")
        return res, sim, peak, "no LUT kernel (BP: torch ops)"
    return res, sim, peak, run_launches(sim.decoder, what, example_launches)


def odd_width(sim, snr_db, what):
    """One batch of the simulator's own draw at snr_db through its decoder at
    the run's width B and at B - 3 (one frame a thread): the B - 3 frames
    equal the first B - 3 of the full batch; both timed (bench.time_decode,
    3 calls after 2 warm-ups) and the one-frame launches of one call at
    B - 3 counted.  Returns (ms at B, ms at B - 3, one-frame launches, class
    launches)."""
    import torch

    from lut_ldpc_torch import bench
    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.ops.pmf import snr2sig

    B = sim.config.sim.batch_size
    sigma = torch.tensor(float(snr2sig(sim.rate, snr_db)), dtype=torch.float32,
                         device=sim.device)
    lc, lm = sim.quantize(sim.draw(0, 0, 0, sigma)[2])
    full_s, out = bench.time_decode(sim.decoder, lc, lm, 3)
    lc3, lm3 = lc[: B - 3].contiguous(), lm[: B - 3].contiguous()
    qk.reset_launches()
    odd = sim.decoder(lc3, lm3)
    torch.cuda.synchronize()
    one = sum(qk.ONE_FRAME_LAUNCHES.values())
    cls = sum(qk.CLASS_LAUNCHES.values())
    same([o[: B - 3] for o in out], odd, f"{what}: B - 3 frames against the full batch")
    odd_s, _ = bench.time_decode(sim.decoder, lc3, lm3, 3)
    if one < 1:
        raise AssertionError(f"{what}: no launch at one frame a thread at B - 3")
    return full_s * 1e3, odd_s * 1e3, one, cls


# the loop the JAX package's BERSim takes for both stored codecs where its
# kernels run: codec files keep no QC structure
# (tests/test_torch_examples.py::test_stored_codecs_pick_the_jax_loop holds
# the port's choice against the JAX package's on the CPU)
STORED_LOOP = "std"
LOOP_PAIRS = {"qc": ("cn_qc_pass", "vn_qc_pass"), "std": ("cn_std_pass", "vn_std_pass"),
              "blocks": ("cn_block_pass", "vn_block_pass")}


def stored_run(sub, run, graph, codec, qc_tag, tmp, dev, smi, results, example_launches):
    """Phase 22e / 22g: dvbs2_waterfall's run_dvbs2_lut with a stored
    thr-0.67 codec at the cliff (1.5-1.8 dB, 8192 frames a point) against
    docs/waterfall/dvbs2_N64800_lut_q4.json by fer_test, the stability
    numbers equal to the file's, every segment on STORED_LOOP's kernel
    pair (no pass of another pair), then each segment's kernels against
    their plain versions at the run's widths."""
    import numpy as np

    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.examples import dvbs2_waterfall as dw

    B, snr, out = dw.BATCH, np.array([1.5, 1.6, 1.7, 1.8]), {}

    def lut67_run():
        out["payload"], res, _, sim = dw.run_dvbs2_lut(graph, codec, snr, 8192, B, tmp,
                                                       qc_tag=qc_tag, device=dev)
        return res, sim

    res, sim, peak, text = monte_carlo(lut67_run, f"22{sub} {run}", example_launches)
    loops = sorted({seg.loop for seg, _ in segments(sim.decoder)})
    others = [n for loop, pair in LOOP_PAIRS.items() if loop != STORED_LOOP
              for n in pair if qk.LAUNCHES[n]]
    if loops != [STORED_LOOP] or others:
        raise AssertionError(f"22{sub}: segments on the {loops} loop, passes of {others}; "
                             f"the JAX package takes the {STORED_LOOP} loop")
    with open(os.path.join(ROOT, "docs", "waterfall", "dvbs2_N64800_lut_q4.json")) as f:
        ref = json.load(f)
    idx = [ref["snr_db"].index(float(s)) for s in snr]
    rows = curve_rows(res, [ref["frames"][i] for i in idx],
                      [ref["frame_errors"][i] for i in idx], f"22{sub} {run}")
    pay = out["payload"]
    for key in ("lam2", "lam2_stable_at_1dB", "thr_snr_db"):
        if not np.isclose(pay[key], ref[key], rtol=1e-12, atol=0):
            raise AssertionError(f"22{sub}: {key} {pay[key]} against the stored {ref[key]}")
    log(f"# phase 22{sub}: {run} (stored codec, graph N={graph.nvar} with "
        f"{len(getattr(graph, 'phantoms', ()))} phantom edge(s), the codec's "
        f"{codec.graph.num_edges} edges) " + run_summary(res, sim, peak, f"B={B}")
        + f", the table tail in {sim.decoder.tail_runs} of {int(res.frames.sum()) // B} "
        f"batches, the {loops[0]} loop as in the JAX package; {text}; FER " + rows
        + f"; lam2 {pay['lam2']:.6f}, stable limit {pay['lam2_stable_at_1dB']:.6f}, "
        f"threshold {pay['thr_snr_db']} dB: the stored values; on {smi}")
    hold_segments(sim.decoder, [B, B // 4], f"phase 22{sub} {run}", results)


def example_workflows(dev, smi, codecs, tmp, results, example_launches):
    """Phase 22: the DVB-S2-scale waterfalls and BASELINE.json config 2
    through the port's example workflows (lut_ldpc_torch/examples), each
    curve held against its TPU-era file in docs/waterfall/ by fer_test."""
    import tempfile

    import torch

    from lut_ldpc_torch.cli import ber_sim
    from lut_ldpc_torch.decoder import BPDecoder, LUTCodec
    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.examples import dvbs2_qc_equivalence as eq
    from lut_ldpc_torch.examples import dvbs2_waterfall as dw
    from lut_ldpc_torch.sim import BERSim, BERSimResults, parse_ini
    from lut_ldpc_torch.sim.config import _parse_range

    B, docs = dw.BATCH, os.path.join(ROOT, "docs", "waterfall")

    def stored(name):
        if name.endswith(".npz"):
            return BERSimResults.load(os.path.join(docs, name))
        with open(os.path.join(docs, name)) as f:
            return json.load(f)

    # 22a / 22b: q4 min-LUT at 0.90 on the PEG and the QC N=64800 codes, the
    # JAX example's grid and stop rules (Nframes 16384, Nfers 200, ber_min
    # 1e-8)
    curves = {}
    for sub, run in (("a", "lut64800"), ("b", "lut64800_qc")):
        t0 = time.perf_counter()
        codec, snr = codecs[run], _parse_range(dw.SNR[run])

        def lut_run():
            res, _, sim = dw.simulate(codec.graph, snr, 16384, B, codec=codec, nfers=200,
                                      ber_min=1e-8, fer_min=1e-10, device=dev, out_dir=tmp)
            return res, sim

        res, sim, peak, text = monte_carlo(lut_run, f"22{sub} {run}", example_launches)
        dw.write_run(dw.TAGS[run], res, res.runtime, snr, tmp)
        curves[run] = res
        if run == "lut64800":
            ref = stored("lut_dv02-17_N64800_q4.npz")
            rows = curve_rows(res, ref.frames, ref.frame_errors, "22a lut64800")
        else:  # another code of the ensemble: printed beside 22a, not held
            a = curves["lut64800"]
            rows = "against 22a's PEG code: " + curve_rows(res, a.frames, a.frame_errors,
                                                          "22b", hold=False)
        log(f"# phase 22{sub}: {run} " + run_summary(res, sim, peak, f"B={B}")
            + f"; {text}; FER " + rows + f" on {smi}")
        hold_segments(sim.decoder, [B, B // 4], f"phase 22{sub} {run}", results)
        if run == "lut64800":
            ms, ms_odd, one, cls = odd_width(sim, 1.2, "phase 22a")
            log(f"# phase 22a: one 1.2 dB batch through {type(sim.decoder).__name__}: "
                f"B={B} {ms:.3f} ms, B={B - 3} {ms_odd:.3f} ms (ratio {ms_odd / ms:.4f}); "
                f"bits, ok and iters of the {B - 3} frames equal to the full batch's; "
                f"{one} of {cls} class launches at one frame a thread at B={B - 3}")
        del sim
        log(f"# phase 22{sub} took {time.perf_counter() - t0:.1f}s")

    # 22c: float sum-product on the DVB-S2 matrix (Nframes 2048, Nfers 200)
    t0 = time.perf_counter()
    graph = codecs["dvbs2_gather"].graph
    snr = _parse_range(dw.SNR["dvbs2_spa"])

    def spa_run():
        bp = BPDecoder(graph, dev, 50, algorithm="spa")
        res, _, sim = dw.simulate(graph, snr, 2048, B, bp=bp, nfers=200, device=dev,
                                  out_dir=tmp)
        return res, sim

    res, sim, peak, text = monte_carlo(spa_run, "22c dvbs2_spa", example_launches, lut=False)
    ref = stored("dvbs2_N64800_spa.npz")
    log("# phase 22c: dvbs2_spa " + run_summary(res, sim, peak, f"B={B}") + f"; {text}; FER "
        + curve_rows(res, ref.frames, ref.frame_errors, "22c dvbs2_spa") + f" on {smi}")
    del sim
    log(f"# phase 22c took {time.perf_counter() - t0:.1f}s")

    # 22d: the two realizations with the thr-0.90 design, 8192 frames a
    # point, Nfers 1e9, skipping off
    t0 = time.perf_counter()
    snrs, frames = [0.8, 1.0, 1.2, 1.4], 8192
    ref = stored("dvbs2_qc_equivalence.json")
    got = {}
    for real, key in (("qc", "dvbs2"), ("gather", "dvbs2_gather")):
        codec = codecs[key]

        def eq_run():
            res, _, sim = eq.run(codec.graph, snrs, frames, B, 0.90, device=dev, codec=codec)
            return res, sim

        res, sim, peak, text = monte_carlo(eq_run, f"22d {real}", example_launches)
        got[real] = res
        log(f"# phase 22d: {real} realization " + run_summary(res, sim, peak, f"B={B}")
            + f"; {text}; FER against the TPU-era {real}: "
            + curve_rows(res, [ref["frames"]] * len(snrs), ref[real]["frame_errors"],
                         f"22d {real}") + f" on {smi}")
        hold_segments(sim.decoder, [B, B // 4], f"phase 22d {real}", results)
        del sim
    payload = eq.payload_of(snrs, frames, 0.90, got["qc"], got["qc"].runtime,
                            got["gather"], got["gather"].runtime)
    log("# phase 22d: QC against gather in the port: "
        + curve_rows(got["qc"], got["gather"].frames, got["gather"].frame_errors,
                     "22d QC against gather") + f"; fer_z_scores {payload['fer_z_scores']}")
    log(f"# phase 22d took {time.perf_counter() - t0:.1f}s")

    # 22e / 22g: the stored thr-0.67 codec on the alist's realization and the
    # stored QC codec on the Z=360 one (load_periodic_alist, one phantom
    # edge), 8192 frames a point, skipping off (run_dvbs2_lut's Nfers,
    # 10000, is above them), both against the alist curve (the same matrix)
    for sub, run, g, qc_tag in (("e", "dvbs2_lut", graph, ""),
                                ("g", "dvbs2_lut_qc", dw.graph_of("dvbs2_lut_qc"), "_qc")):
        t0 = time.perf_counter()
        stored_run(sub, run, g, codecs["stored" + qc_tag], qc_tag, tmp, dev, smi, results,
                   example_launches)
        log(f"# phase 22{sub} took {time.perf_counter() - t0:.1f}s")

    # 22f: BASELINE.json config 2 through the ber_sim CLI: the INI as it is,
    # its results and designed codec sent to a temporary directory
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(ROOT, "params", "ber.ini.irregular.example")) as f:
            text_ini = f.read()
        ini, codec_path = os.path.join(d, "ber.ini.irregular.example"), os.path.join(d, "c.npz")
        with open(ini, "w") as f:
            f.write(text_ini.replace("[Sim]\n", f"[Sim]\nresults_dir = {d}/results\n"
                                                f"codec_filename = {codec_path}\n", 1))
        torch.cuda.reset_peak_memory_stats()
        qk.reset_launches()
        if ber_sim.main(["-p", ini, "-s", "0", "-b", ROOT]) != 0:
            raise AssertionError("22f: ber_sim CLI failed")
        cli_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        cfg = parse_ini(ini)
        codec = LUTCodec.load(codec_path)
        sim = BERSim(cfg, codec.graph, dev, codec=codec)  # the decoder the CLI built
        text = run_launches(sim.decoder, "22f config 2", example_launches)
        (base,) = os.listdir(os.path.join(d, "results"))
        res = BERSimResults.load(os.path.join(d, "results", base, f"{base}_rseed0000.npz"))
    ref = stored("lut_irregular_N500_q4.json")
    log(f"# phase 22f: ber_sim CLI on params/ber.ini.irregular.example in {cli_s:.1f}s with "
        f"the design, " + run_summary(res, sim, peak, f"B={cfg.sim.batch_size}")
        + f"; {text}; FER " + curve_rows(res, ref["frames"], ref["frame_errors"],
                                         "22f config 2") + f" on {smi}")
    hold_segments(sim.decoder, [cfg.sim.batch_size], "phase 22f config 2", results)
    log(f"# phase 22f took {time.perf_counter() - t0:.1f}s")


def fused_hold(dec, B, scan_len, what, results):
    """The fused harness of perf_regress on the card against its plain
    version: on the harness's own inputs (integers in [-2000, 2000)), one
    cn_qc_pass, then one and scan_len chained iterations (iteration 0's
    parameters) equal on the real rows (tolerance zero); the differences go
    into the kernels line.  Returns the log text."""
    import torch

    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.tools import perf_regress as pr

    def err(a, b, real):
        return float((a[real].double() - b[real].double()).abs().max())

    m, cha = pr.fused_inputs(dec, B)
    cn, synd = qk.cn_qc_pass(m, dec.tables)
    cn_ref, synd_ref = qk.cn_qc_pass_ref(m, dec.tables)
    errs = {"cn_qc_pass": err(cn, cn_ref, dec.tables.cn_real), "vn_qc_pass": 0.0}
    for n in (1, scan_len):
        errs["vn_qc_pass"] = max(errs["vn_qc_pass"], err(
            pr.fused_chain(dec, m, cha, n), pr.fused_chain(dec, m, cha, n, plain=True),
            dec.tables.vn_real))
    torch.cuda.synchronize()
    if any(errs.values()) or not torch.equal(synd, synd_ref):
        raise AssertionError(f"{what}: the fused chain differs from its plain version: "
                             f"{errs}, syndromes equal {torch.equal(synd, synd_ref)}")
    for name, e in errs.items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
    return (f"{what} {dec.dtype} B={B}: cn_qc_pass and 1 and {scan_len} chained iterations "
            f"equal to the plain chain on the real rows")


def regress_phase(dev, smi, codecs, results):
    """Phase 23: lut_ldpc_torch.tools.perf_regress on the card: `record`
    twice into a temporary ledger (phase 2's codecs handed over where the
    designs are the same), `check` 0 on the two, then 1 once a third record
    with the headline decode 1.5 times slower is appended.  Every pass went
    through the CN frames or the generated VN kernels, none through a
    table-driven witness, no block kernel ran.  Then the kernels at the
    shapes the records gave them, against their plain versions: both fused
    chains on their own inputs, and the CN frames and generated VN kernels
    of the N=64800 QC, DVB-S2 and PEG decoders at B=1024 (and 1021; the
    headline's B=8192 decoders are phases 3-5's).  Returns the passes per
    kernel."""
    import tempfile

    from lut_ldpc_torch.decoder import ArithLUTDecoder
    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.tools import perf_regress as pr

    with tempfile.TemporaryDirectory() as d:
        ledger = os.path.join(d, "kernels_torch.json")
        qk.reset_launches()
        for i in (1, 2):
            t0 = time.perf_counter()
            entry = pr.record(dev, codecs=codecs)
            pr.append(entry, ledger)
            log(f"# phase 23: record {i} in {time.perf_counter() - t0:.1f}s: "
                + json.dumps(entry))
        passes = dict(qk.LAUNCHES)
        run = LOOP_PAIRS["qc"] + LOOP_PAIRS["std"]
        if (any(qk.WITNESS_LAUNCHES.values()) or not all(passes[n] for n in run)
                or any(passes[n] for n in LOOP_PAIRS["blocks"])):
            raise AssertionError(f"phase 23: passes {passes}, on a witness "
                                 f"{dict(qk.WITNESS_LAUNCHES)}")
        if entry["compile_vn_units"] < 1:
            raise AssertionError("phase 23: compile_s compiled no generated VN unit")
        if pr.check(0.12, ledger) != 0:
            raise AssertionError("phase 23: check flags two records of one tree")
        slow = dict(entry, ts=time.time(), headline_decode_ms=entry["headline_decode_ms"] * 1.5)
        pr.append(slow, ledger)
        if pr.check(0.12, ledger) != 1:
            raise AssertionError("phase 23: check misses a 1.5x headline decay")
    log(f"# phase 23: perf_regress record x2, check 0, a 1.5x headline decay check 1; "
        f"passes {', '.join(f'{n} {passes[n]}' for n in run)}, none on a witness; "
        f"compile_s built {entry['compile_vn_units']} VN units cold; on {smi}")
    t0 = time.perf_counter()
    for name, B, scan_len in (("headline", 8192, 16), ("n64800_qc", 1024, 8)):
        log("# phase 23: " + fused_hold(pr.fused_decoder(codecs[name], dev), B, scan_len,
                                         f"fused {name}", results))
    held = [("n64800_qc", pr.fused_decoder(codecs["n64800_qc"], dev))] + [
        (name, ArithLUTDecoder(codecs[name], dev, early_exit=True)) for name in ("dvbs2", "peg")]
    for name, dec in held:
        hold_segments(dec, [1024], f"phase 23 {name} ({dec.loop} loop)", results)
    del held
    log(f"# phase 23: kernels held at the records' shapes in {time.perf_counter() - t0:.1f}s")
    return passes


def _err(a, b):
    """Largest absolute difference of two tensors of one shape."""
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def glue_check(dec, lc, lm, what, rows, reps):
    """Phase 24: the loop's glue kernels of `dec` at the width B of the
    labels (lc, lm: (B, nvar) int32 on the card) and at B - 3 against their
    plain versions, max_abs_err 0 or the script fails: the init kernel on
    the labels as int32 and as int64, the loop-state kernel and its live
    count, and the latch kernel on random flags (about one frame in 19
    converging, as in a decode of about 19 iterations).  At B the times
    (CUDA events), the plain versions' times, the bounds, the latch's
    torch.where, the latch with no frame converging, and the loop's VN pass
    on iteration 0's values beside them; fills rows[name] with the largest
    error over the widths and the times at the first shapes it meets."""
    import torch

    from lut_ldpc_torch import profile_kernels as pk
    from lut_ldpc_torch.decoder import loop_glue as lg

    dev, nvp, nvar = dec.device, dec.layout.nvar_pad, dec.nvar
    E, size = dec.layout.num_edges_vn, dec.dtype.itemsize
    B = lc.shape[0]
    it = dec.S // 2
    init_args = (dec._init_tab, dec.ten.leaf_cha, dec.ten.leaf_msg0, dec._pin, E)
    parts = []
    for width in (B, B - 3):
        gen = torch.Generator(dev).manual_seed(width)
        flags = lambda p: torch.rand(width, generator=gen, device=dev) < p
        bits = lambda: torch.randint(0, 2, (nvp, width), generator=gen, device=dev,
                                     dtype=torch.int8)
        err = dict.fromkeys(("init_values", "loop_state", "latch"), 0.0)
        for lab in (torch.int32, torch.int64):
            cha, msg = lc[:width].to(lab), lm[:width].to(lab)
            got = lg.init_values(cha, msg, *init_args)
            want = lg.init_values_ref(cha, msg, *init_args)
            err["init_values"] = max(err["init_values"],
                                     *(_err(g, w) for g, w in zip(got, want)))
        del got, want
        unan, synd, done = flags(0.5), flags(0.5), flags(0.3)
        iters = torch.randint(0, 50, (width,), generator=gen, device=dev, dtype=torch.int32)
        live = lg.LiveCount(dev)
        d_k, i_k, d_r, i_r = done.clone(), iters.clone(), done.clone(), iters.clone()
        conv_k = lg.loop_state(unan, synd, d_k, i_k, it, live)
        conv_r = lg.loop_state_ref(unan, synd, d_r, i_r, it)
        err["loop_state"] = max(_err(conv_k, conv_r), _err(d_k, d_r), _err(i_k, i_r),
                                abs(live.read() - int((~d_r).sum())))
        conv, prev, lat0 = flags(1 / 19), bits(), bits()
        l_k, l_r = lat0.clone(), lat0.clone()
        lg.latch(conv, prev, l_k)
        lg.latch_ref(conv, prev, l_r)
        err["latch"] = _err(l_k, l_r)
        bad = {n: e for n, e in err.items() if e != 0.0}
        if bad:
            raise AssertionError(f"{what} B={width}: kernels differ from their plain "
                                 f"versions: {bad}")
        for n, e in err.items():
            rows.setdefault(n, {"max_abs_err": 0.0})
            rows[n]["max_abs_err"] = max(rows[n]["max_abs_err"], e)
        if width != B:
            continue
        # times at B
        n_conv = int(conv.sum())
        t = {"init_values": (
            pk.cuda_ms(lambda: lg.init_values(lc, lm, *init_args), reps),
            pk.cuda_ms(lambda: lg.init_values_ref(lc, lm, *init_args), 2), None,
            pk.bound_ms(2 * B * nvar * 4 + (nvp + E) * B * size, 0))}
        t["loop_state"] = (
            pk.cuda_ms(lambda: lg.loop_state(unan, synd, d_k, i_k, it, live), reps),
            pk.cuda_ms(lambda: lg.loop_state_ref(unan, synd, d_r, i_r, it), reps), None,
            pk.bound_ms(13 * B + 4, 0))
        live.read()
        t["latch"] = (
            pk.cuda_ms(lambda: lg.latch(conv, prev, l_k), reps),
            pk.cuda_ms(lambda: lg.latch_ref(conv, prev, l_r), reps),
            pk.cuda_ms(lambda: torch.where(conv[None, :], prev, l_r, out=l_r), reps),
            pk.bound_ms(B + 2 * nvp * n_conv, 0))
        idle = pk.cuda_ms(lambda: lg.latch(torch.zeros_like(conv), prev, l_k), reps)
        vcha, state = dec._init(lc, lm)
        m_cn = dec._cn(state[0])[0]
        del state
        vn_ms = pk.cuda_ms(lambda: dec._vn(m_cn, vcha, 0), reps)
        del m_cn, vcha
        for n, (ms, plain, lib, (bnd, by)) in t.items():
            parts.append(f"{n} {ms:.4f} ms (plain {plain:.4f}"
                         + (f", torch.where {lib:.4f}" if lib is not None else "")
                         + f", bound {bnd:.4f} {by})")
            if "ms" not in rows[n]:  # the first shapes a kernel was timed at
                rows[n].update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                               bound_by=by, shapes=f"{what}, B={B}")
        rows["latch"].setdefault("idle_ms", idle)
        parts.append(f"latch with {n_conv} of {B} frames converging {t['latch'][0]:.4f} ms, "
                     f"with none {idle:.4f}, beside the VN pass {vn_ms:.4f} ms "
                     f"(bound {bounds(dec, B)['vn'][0]:.4f})")
    log(f"# {what}: glue kernels equal to their plain versions at B={B} and {B - 3} "
        f"(max_abs_err 0); " + "; ".join(parts))


def glue_phase(dev, smi, head_codec, dvb_codec, peg_codec, rows, widths=(8192, 4096, 2048)):
    """Phase 24: the value-domain loop's glue on the card (csrc/loop_glue.cu).
    Each glue kernel against its plain version (``glue_check``) at the
    headline shapes (QC int16 and the block loop, B=8192 and 8189), DVB-S2
    (QC float32 with its phantom, 4096 / 4093) and PEG std (int16, 2048 /
    2045), on the labels the main path decodes; then that main path, the
    launch counts set to 0 just before each decode and read just after
    (the headline and DVB-S2 decoders of make_staged_decoder, the headline
    batch on the block loop, the PEG decoder at B=2048): every glue kernel
    launched, the first 256 frames equal to the plain twin's; last the
    headline's time and one traced decode (device busy, glue: the device
    time of every kernel other than the CN and VN passes, idle share).
    widths: the headline's, DVB-S2's and PEG's batch widths.  Fills
    rows[name]["launches"]."""
    import numpy as np
    import torch

    from lut_ldpc_torch import bench, bench_n64800 as b64
    from lut_ldpc_torch.decoder import (ArithLUTDecoder, build_arith_prefix_spec,
                                        make_staged_decoder, plain_twin)
    from lut_ldpc_torch.decoder import loop_glue as lg
    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.profile_decode import PASS_KERNEL, device_breakdown

    wh, wd, wp = widths
    head_spec = build_arith_prefix_spec(head_codec, dtype=np.int16)
    peg_spec = build_arith_prefix_spec(peg_codec, dtype=np.int16)
    labels = {}
    for name, codec, B, snr in (("headline", head_codec, wh, 2.0),
                                ("DVB-S2", dvb_codec, wd, b64.SNR_DB),
                                ("PEG", peg_codec, wp, b64.SNR_DB)):
        labels[name] = tuple(torch.as_tensor(a, device=dev)
                             for a in bench.channel_labels(codec, B, snr))
    # (what, labels, the decoder checked, its loop, reps; the main-path decoder)
    cases = [
        ("headline QC int16", "headline", lambda: ArithLUTDecoder(head_codec, dev,
                                                                  spec=head_spec), "qc", 20,
         lambda: make_staged_decoder(head_codec, dev)),
        ("headline block loop int16", "headline", lambda: ArithLUTDecoder(
            head_codec, dev, spec=head_spec, loop="blocks"), "blocks", 20, None),
        ("DVB-S2 QC float32", "DVB-S2", lambda: ArithLUTDecoder(dvb_codec, dev), "qc", 10,
         lambda: make_staged_decoder(dvb_codec, dev, max_batch=wd)),
        ("PEG std int16", "PEG", lambda: ArithLUTDecoder(peg_codec, dev, spec=peg_spec),
         "std", 5, lambda: make_staged_decoder(peg_codec, dev, max_batch=wp))]
    for n in ("loop_state", "latch", "init_values"):
        rows.setdefault(n, {"max_abs_err": 0.0})["launches"] = 0
    head = None
    for what, name, build, loop, reps, main in cases:
        dec = build()
        if dec.loop != loop:
            raise AssertionError(f"phase 24: {what} on the {dec.loop} loop")
        lc, lm = labels[name]
        glue_check(dec, lc, lm, f"phase 24: {what}", rows, reps)
        if main is not None:  # the block loop's decoder is its own main path
            dec = main()
        qk.reset_launches()
        lg.reset_launches()
        out = dec(lc, lm)
        torch.cuda.synchronize()
        counts = dict(lg.LAUNCHES)
        if min(counts.values()) < 1 or any(qk.WITNESS_LAUNCHES.values()):
            raise AssertionError(f"phase 24: the {what} decode launched {counts} glue "
                                 f"kernels, {dict(qk.WITNESS_LAUNCHES)} witnesses")
        for n, c in counts.items():
            rows[n]["launches"] += c
        check_shapes(out, lc.shape[0], lc.shape[1])
        n = 256
        same([o[:n] for o in out], plain_twin(dec)(lc[:n], lm[:n]),
             f"phase 24: {what} kernels vs plain twin")
        log(f"# phase 24: {what}: {type(dec).__name__} decode of {lc.shape[0]} frames: "
            f"glue launches {counts}; first {n} frames equal to the plain twin; mean iters "
            f"{float(out[2].float().mean()):.4f}")
        if name == "headline" and main is not None:
            head = dec
        del dec, out
        torch.cuda.empty_cache()
    lc, lm = labels["headline"]
    dt_s, _ = bench.time_decode(head, lc, lm, bench.REPS)
    from torch.profiler import ProfilerActivity, profile

    # a trace that lost the start of the decode (seen once: 21 of 29
    # loop-state launches) is taken again, up to three times
    for attempt in range(3):
        lg.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            head(lc, lm)
            torch.cuda.synchronize()
        table, busy, span = device_breakdown(prof)
        traced = sum(c for name, c, _ in table if "loop_state_kernel" in name)
        if traced == lg.LAUNCHES["loop_state"]:
            break
    if busy == 0.0:
        raise AssertionError("phase 24: the profiler recorded no device time")
    passes = sum(ms for name, _, ms in table if PASS_KERNEL.search(name))
    glue = [(name, c, ms) for name, c, ms in table if not PASS_KERNEL.search(name)]
    log(f"# phase 24: headline {dt_s * 1e3:.3f} ms a call "
        f"({wh * head_codec.k / dt_s / 1e6:.3f} Mbit/s); traced ({traced} of "
        f"{lg.LAUNCHES['loop_state']} loop-state launches in the trace, attempt "
        f"{attempt + 1}): busy {busy:.3f} ms, "
        f"passes {passes:.3f}, glue {busy - passes:.3f} ms, idle "
        f"{100 * (1 - busy / span):.1f} % of the span; glue by kernel: "
        + "; ".join(f"{name[:60]} x{c} {ms:.3f}" for name, c, ms in glue[:8]) + f" on {smi}")


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
    import shutil
    import tempfile

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
    # saved for phase 21b's ranks, which load it instead of designing it
    tmp = tempfile.mkdtemp()
    head_path = os.path.join(tmp, "headline.npz")
    head_codec.save(head_path)
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
        # phase 22's codecs that the phases above lack, and their units
        from lut_ldpc_torch.core.tanner import TannerGraph
        from lut_ldpc_torch.examples import dvbs2_waterfall as dw

        ex_codecs = {"lut64800": codec, "dvbs2": dvb_codec,
                     "lut64800_qc": b64.build_codec("qc"),
                     "dvbs2_gather": LUTCodec.design(
                         TannerGraph.from_alist(dw.DVBS2_ALIST), b64.DESIGN_THR**2,
                         max_iters=b64.MAX_ITERS, Nq_Cha=16, Nq_Msg=16),
                     "stored": dw.stored_codec(None, "", tmp),
                     "stored_qc": dw.stored_codec(None, "_qc", tmp)}
        auto = [(build_arith_prefix_spec, np.int16, ("auto",)),
                (build_arith_spec, np.float32, ("auto",))]
        prefixes = [(build_arith_prefix_spec, dt, ("auto",)) for dt in (np.int16, np.float32)]
        start_vn_builds({"QC N=64800": (ex_codecs["lut64800_qc"], auto),
                         "DVB-S2 from the alist": (ex_codecs["dvbs2_gather"], full),
                         "DVB-S2 thr 0.67": (ex_codecs["stored"], prefixes),
                         "DVB-S2 thr 0.67 QC": (ex_codecs["stored_qc"], prefixes)}, libs)
        finish_builds(builds, libs)
        log(f"#   {len(builds) + len(libs)} libraries built side by side in "
            f"{time.perf_counter() - t0:.1f}s")
        head_dec, head_lc, head_lm, head_mbits, head_iters = headline(
            dev, smi, head_codec, results, launches)
        torch.cuda.empty_cache()
        # the PEG rank (a third busy worker) starts after the headline's
        # timed phase
        rank = pool.apply_async(b64.info_bits, ("peg",))
        rank_qc = pool.apply_async(b64.info_bits, ("qc",))  # phase 22b's k
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
        # the GF(2) ranks the workers computed (minutes of host time here)
        codec.nchk_lin_indep = codec.nvar - peg_k
        qc_codec = ex_codecs["lut64800_qc"]
        qc_codec.nchk_lin_indep = qc_codec.nvar - rank_qc.get()[0]
    # the workers have ended: the simulator's step is timed on a quiet host
    t0 = time.perf_counter()
    sim_step(dev, smi, head_codec, head_mbits, head_iters, results)
    log(f"# phase 17 took {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    de_explorers(dev, smi)
    log(f"# phase 20 took {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_line = mesh_phase(dev, smi, head_codec, head_path, results)
    log(f"# phase 21 took {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    example_launches = {n: [0, 0] for n in REPLACES}
    example_workflows(dev, smi, ex_codecs, tmp, results, example_launches)
    shutil.rmtree(tmp)
    log(f"# phase 22 took {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    regress_launches = regress_phase(dev, smi, {
        "headline": head_codec, "n64800_qc": ex_codecs["lut64800_qc"], "dvbs2": dvb_codec,
        "peg": codec}, results)
    log(f"# phase 23 took {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    glue_rows = {}
    glue_phase(dev, smi, head_codec, dvb_codec, codec, glue_rows)
    log(f"# phase 24 took {time.perf_counter() - t0:.1f}s")

    print(json.dumps({"mesh": mesh_line}))

    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=SOURCES[n], replaces=REPLACES[n],
             launches=launches[n], **results[n], example_launches=example_launches[n][0],
             example_one_frame_launches=example_launches[n][1],
             regress_launches=regress_launches[n])
        for n in REPLACES] + [
        dict(name=n, route="cuda", source=GLUE_SOURCE, replaces=r, **glue_rows[n])
        for n, r in GLUE_REPLACES.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
