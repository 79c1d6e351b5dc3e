"""The generated VN kernels against the table-driven ones and the plain
versions, with times.

    python -m lut_ldpc_torch.profile_vn [--code headline|peg|qc|dvbs2|dvbs2-gather]
        [--dtype int16|float32|both] [--batch B] [--reps 20] [--snr DB] [--sass]

Builds the codec of ``lut_ldpc_torch.bench`` (headline) or
``bench_n64800`` (the others), the decoder's spec in the chosen dtype
(the full float32 spec for the DVB-S2 matrices, the prefix spec otherwise)
and one VN input at a middle iteration: random entries of the iteration's
value table through the CN pass, channel values from the leaf table
(``np.random.default_rng(1)``).  The generated ``vn_qc_pass`` /
``vn_std_pass`` must equal the table-driven kernel (``generic=True``) and the
plain version on the real rows, the bits and the unanimity flags, at the
batch width and at an odd width 3 below it (one frame a thread); then CUDA
event times of both kernels, the bound for the same work, what ptxas reports
per class and the build time.  ``--snr`` takes the input from a decode at
that SNR instead, ``--sass`` adds an opcode histogram of each kernel.

Needs a CUDA device.  Prints the card's name and power limit first.
``check_vn`` is the part ``chip_smoke.py`` shares.
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def decode_input(dec, it: int, B: int, snr_db: float, seed: int = 0):
    """(VN-pass input messages, channel values) of `dec` at iteration `it` of
    a decode of B noisy frames at `snr_db` (no early exit, no funnel): what
    the main path hands the VN kernel."""
    import torch

    from . import bench

    lc, lm = bench.channel_labels(dec.codec, B, snr_db, seed=seed)
    vcha, state = dec._init(torch.as_tensor(lc, device=dec.device),
                            torch.as_tensor(lm, device=dec.device))
    m_vn = state[0]
    del state
    for k in range(it):
        m_cn, _ = dec._cn(m_vn)
        m_vn, _, _ = dec._vn(m_cn, vcha, k)
    m_c2v, _ = dec._cn(m_vn)  # CN-grouped on the QC loop, VN-grouped on std
    return m_c2v, vcha


def sass_histogram(path: str, top: int = 14) -> list:
    """Per kernel of the library at `path`: instruction count and the most
    frequent opcodes of its SASS (cuobjdump), as lines."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    out, name, ops = [], None, collections.Counter()

    def flush():
        if name and ops:
            short = re.sub(r"^_ZN\d+lutvn\d+", "", name)[:48]
            out.append(f"{short}: {sum(ops.values())} instructions; "
                       + ", ".join(f"{o} {n}" for o, n in ops.most_common(top)))

    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            flush()
            name, ops = m.group(1), collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_]*)", line)
        if m:
            ops[m.group(1)] += 1
    flush()
    return out


def vn_input(dec, it: int, B: int, seed: int = 1):
    """(VN-pass input messages, channel values) of `dec` at iteration `it`:
    random value-table entries through the CN pass.  Nearly every node of
    such an input disagrees in sign, in every frame."""
    import numpy as np
    import torch

    from .decoder import qc_kernels as qk
    from .decoder.hybrid import root_levels

    tab, dev = dec.tables, dec.device
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(root_levels(dec.spec, it), device=dev).to(dec.dtype)
    m = table[torch.as_tensor(rng.integers(0, len(table), (tab.rows_vn, B)), device=dev)]
    leaf = torch.as_tensor(np.asarray(dec.spec.leaf_cha), device=dev).to(dec.dtype)
    cha = leaf[torch.as_tensor(rng.integers(0, len(leaf), (tab.nvar_pad, B)), device=dev)]
    cn = qk.cn_qc_pass if dec.loop == "qc" else qk.cn_std_pass
    return cn(m, tab)[0], cha


def check_vn(dec, it: int, m_c2v, cha, reps: int = 20, plain_reps: int = 0):
    """The generated VN kernel of `dec` (a QC- or std-loop ArithLUTDecoder on
    a CUDA device) against the table-driven kernel and the plain version on
    one input; raises AssertionError on any difference.  Returns dict(name,
    max_abs_err, ms, generic_ms, plain_ms (None unless plain_reps))."""
    import torch

    from .decoder import qc_kernels as qk
    from .profile_kernels import cuda_ms

    qc = dec.loop == "qc"
    name = "vn_qc_pass" if qc else "vn_std_pass"
    vn, ref = (qk.vn_qc_pass, qk.vn_qc_pass_ref) if qc else (qk.vn_std_pass, qk.vn_std_pass_ref)
    tab, prm = dec.tables, dec.params
    real, nodes = tab.vn_real, tab.node_real
    got = vn(m_c2v, cha, it, prm, tab)
    torch.cuda.synchronize()
    err = 0.0
    for what, fn in (("the table-driven kernel", lambda: vn(m_c2v, cha, it, prm, tab, generic=True)),
                     ("its plain version", lambda: ref(m_c2v, cha, it, prm, tab))):
        want = fn()
        torch.cuda.synchronize()
        e = float((got[0][real].double() - want[0][real].double()).abs().max())
        err = max(err, e)
        if (e != 0 or not torch.equal(got[1][nodes], want[1][nodes])
                or not torch.equal(got[2], want[2])):
            raise AssertionError(f"generated {name} disagrees with {what} (max err {e})")
        del want
    unan_true = int(got[2].sum())
    del got
    return dict(
        name=name, max_abs_err=err, unan_true=unan_true,
        ms=cuda_ms(lambda: vn(m_c2v, cha, it, prm, tab), reps),
        generic_ms=cuda_ms(lambda: vn(m_c2v, cha, it, prm, tab, generic=True),
                           max(1, reps // 4)),
        plain_ms=(cuda_ms(lambda: ref(m_c2v, cha, it, prm, tab), plain_reps)
                  if plain_reps else None))


def describe_build(lib, classes) -> list:
    """Lines on a generated unit: build time and, per kernel instantiation,
    what ptxas reports."""
    from .decoder.vn_codegen import ptxas_by_kernel

    out = [f"unit {lib.hash[:16]}: {len(lib.text)} characters, built in "
           f"{lib.seconds:.1f}s" + ("" if lib.seconds else " (library file reused)")]
    for r in ptxas_by_kernel(lib.report):
        out.append(f"  {r['kernel']} class {r['cls']} (degree {classes[r['cls']].degree}), "
                   f"{r['vec']} frames a thread: {r['registers']} registers, "
                   f"{r['stack']} B stack, {r['spill_stores']} B spill stores, "
                   f"{r['spill_loads']} B spill loads")
    return out


def build_decoder(code: str, dtype, dev, kernels: bool = True):
    """The ArithLUTDecoder of `code` in `dtype`; kernels=False leaves the
    generated VN unit unbuilt (for callers that launch other kernels)."""
    import numpy as np

    from . import bench, bench_n64800 as b64
    from .decoder import ArithLUTDecoder, build_arith_prefix_spec, build_arith_spec

    codec = bench.build_codec() if code == "headline" else b64.build_codec(code)
    full = code.startswith("dvbs2")
    if full and np.dtype(dtype) != np.float32:
        raise ValueError("the DVB-S2 matrices decode on their full float32 spec")
    spec = (build_arith_spec if full else build_arith_prefix_spec)(codec, dtype=dtype)
    return ArithLUTDecoder(codec, dev, spec=spec, kernels=kernels)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--code", default="headline",
                    choices=["headline", "peg", "qc", "dvbs2", "dvbs2-gather"])
    ap.add_argument("--dtype", default="both", choices=["int16", "float32", "both"])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--snr", type=float, default=None,
                    help="take the input from a decode at this SNR (dB) "
                         "instead of random table entries")
    ap.add_argument("--sass", action="store_true",
                    help="print an opcode histogram of each built kernel")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_vn: needs a CUDA device", file=sys.stderr)
        return 1
    from . import bench, bench_n64800 as b64
    from .decoder import vn_codegen
    from .profile_kernels import bound_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"# card {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    B = args.batch or (bench.BATCH if args.code == "headline" else b64.BATCH)
    dtypes = (["float32"] if args.code.startswith("dvbs2") else
              ["int16", "float32"]) if args.dtype == "both" else [args.dtype]
    for dt in dtypes:
        dec = build_decoder(args.code, np.dtype(dt), dev)
        it = dec.spec.num_iters // 2
        lib = vn_codegen.library(dec.params, dec.dtype, dec.loop)
        lib.handle()
        for line in describe_build(lib, dec.params.classes):
            print(f"# {line}")
        for line in sass_histogram(lib.path) if args.sass else ():
            print(f"#   sass {line}")
        lay, size = dec.layout, dec.dtype.itemsize
        for width in (B, B - 3):
            m_c2v, cha = (vn_input(dec, it, width) if args.snr is None
                          else decode_input(dec, it, width, args.snr))
            nbytes = ((2 * lay.num_edges + lay.nvar) * size + lay.nvar + 1) * width
            bnd = bound_ms(nbytes, 0)[0]
            r = check_vn(dec, it, m_c2v, cha, reps=args.reps)
            print(f"# {args.code} {dt} B={width} it={it}: {r['name']} equal to the "
                  f"table-driven kernel and the plain version; generated "
                  f"{r['ms']:.4f} ms, table-driven {r['generic_ms']:.4f} ms, bytes bound "
                  f"{bnd:.4f} ms ({r['ms'] / bnd:.2f} x), unan true {r['unan_true']}/{width}")
            del m_c2v, cha
        del dec
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
