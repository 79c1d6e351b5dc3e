"""The CN frames against the table-driven CN kernels and the plain versions,
with times.

    python -m lut_ldpc_torch.profile_cn [--code headline|peg|qc|dvbs2|dvbs2-gather ...]
        [--dtype int16|float32|both] [--batch B] [--reps 20]

Builds the codec of ``lut_ldpc_torch.bench`` (headline) or
``bench_n64800`` (the others), the decoder's spec in the chosen dtype (the
full float32 spec for the DVB-S2 matrices, the prefix spec otherwise) and
one CN input: random entries of a middle iteration's value table in every
row of the VN-grouped v2c array, padding rows included
(``np.random.default_rng(1)``).  ``cn_qc_pass`` / ``cn_std_pass`` must equal
the table-driven kernel (``generic=True``) and the plain version on the real
rows and the syndrome, and for a std graph so must the unfolded route (the
two row gathers in torch around the CN frames on the CN-grouped planes), at
the batch width and at an odd width 3 below it (one frame a thread); then
CUDA-event times of the CN frames, the table-driven kernel, the unfolded
route, the bound for the same work and what ptxas reports for the
instantiations that ran.

Needs a CUDA device.  Prints the card's name and power limit first.
``check_cn`` is the part ``chip_smoke.py`` shares.
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def cn_input(dec, it: int, B: int, seed: int = 1):
    """Random entries of iteration `it`'s value table in every row of the
    VN-grouped v2c array (rows_vn, B) of `dec`, every 16th frame taken
    positive (those frames satisfy every check, so that the syndrome has
    flags of both values)."""
    import numpy as np
    import torch

    from .decoder.hybrid import root_levels

    rng = np.random.default_rng(seed)
    table = torch.as_tensor(root_levels(dec.spec, it), device=dec.device).to(dec.dtype)
    idx = rng.integers(0, len(table), (dec.tables.rows_vn, B))
    m = table[torch.as_tensor(idx, device=dec.device)]
    m[:, ::16] = m[:, ::16].abs()
    return m


def unfolded_route(m_vn, tab):
    """The std CN pass without the folded gathers: index_select by perm_v2c,
    the CN frames on the CN-grouped planes (read and written through an
    identity row table), index_select by perm_c2v.  Returns (VN-grouped c2v
    array, synd_ok) as cn_std_pass does; measurement only, on a CUDA
    device."""
    import torch

    from .decoder import qc_kernels as qk

    m_cn = m_vn.index_select(0, tab.perm_v2c)
    out = torch.empty_like(m_cn)
    synd = torch.ones(m_vn.shape[1], dtype=torch.bool, device=m_vn.device)
    ident = torch.arange(tab.rows_cn, dtype=torch.int32, device=m_vn.device)
    qk._cn_std_frames(m_cn, out, synd, tab, ident)
    return out.index_select(0, tab.perm_c2v), synd


def check_cn(dec, m_vn, reps: int = 20, plain_reps: int = 0):
    """The CN frames of `dec`'s loop (a QC- or std-loop ArithLUTDecoder on a
    CUDA device) against the table-driven kernel (where it takes the check
    degree: up to qc_kernels.MAX_DEGREE) and the plain version on one
    VN-grouped input; raises AssertionError on any difference.  Returns
    dict(name, max_abs_err, synd_true, ms, witness_ms (None without the
    table-driven kernel), plain_ms (None unless plain_reps), unfolded_ms
    (std only, else None))."""
    import torch

    from .decoder import qc_kernels as qk
    from .profile_kernels import cuda_ms

    qc = dec.loop == "qc"
    name = "cn_qc_pass" if qc else "cn_std_pass"
    cn, ref = (qk.cn_qc_pass, qk.cn_qc_pass_ref) if qc else (qk.cn_std_pass, qk.cn_std_pass_ref)
    tab = dec.tables
    real = tab.cn_real if qc else tab.vn_real  # rows of the output's layout
    witness = tab.max_dc <= qk.MAX_DEGREE
    got, synd = cn(m_vn, tab)
    torch.cuda.synchronize()
    err = 0.0
    against = [("its plain version", lambda: ref(m_vn, tab))]
    if witness:
        against.insert(0, ("the table-driven kernel", lambda: cn(m_vn, tab, generic=True)))
    for what, fn in against:
        want, w_synd = fn()
        torch.cuda.synchronize()
        e = float((got[real].double() - want[real].double()).abs().max())
        err = max(err, e)
        if e != 0 or not torch.equal(synd, w_synd):
            raise AssertionError(f"{name} disagrees with {what} (max err {e})")
        del want
    if not qc:
        out, u_synd = unfolded_route(m_vn, tab)
        if not (torch.equal(out[real], got[real]) and torch.equal(u_synd, synd)):
            raise AssertionError(f"{name}: the unfolded route disagrees with the pass")
        del out
    del got
    unfolded = None if qc else cuda_ms(lambda: unfolded_route(m_vn, tab), reps)
    return dict(
        name=name, max_abs_err=err, synd_true=int(synd.sum()),
        ms=cuda_ms(lambda: cn(m_vn, tab), reps),
        witness_ms=(cuda_ms(lambda: cn(m_vn, tab, generic=True), max(1, reps // 4))
                    if witness else None),
        plain_ms=cuda_ms(lambda: ref(m_vn, tab), plain_reps) if plain_reps else None,
        unfolded_ms=unfolded)


def cn_bound(dec, B: int):
    """(ms, by) of one CN pass: every real message read once and written
    once, the syndrome flags written; 13 float32 operations an edge."""
    from .profile_kernels import CN_OPS_PER_EDGE, bound_ms

    E = dec.layout.num_edges
    return bound_ms(2 * E * B * dec.dtype.itemsize + B, CN_OPS_PER_EDGE * E * B)


def instantiations(dec, B: int, aligned: int = 1) -> list:
    """(kernel, dtype, width, frames a thread) of the CN frames that a pass
    of `dec` launches at batch width B."""
    import torch

    from .decoder import qc_kernels as qk

    qc = dec.loop == "qc"
    degrees = ({d for _, _, d in dec.tables.cn_runs} if qc
               else {b.degree for b in dec.tables.cn_blocks})
    is_f32 = int(dec.dtype == torch.float32)
    lib = qk._load_cn(is_f32)
    out = []
    for d in sorted(degrees):
        out.append((f"cn_{'qc' if qc else 'std'}_frames_kernel",
                    "float32" if is_f32 else "int16", lib.lut_cn_width(d),
                    lib.lut_cn_vec(is_f32, d, B, aligned)))
    return out


def describe_instantiations(dec, B: int, report: str) -> list:
    """One line per CN frame instantiation that a pass of `dec` launches at
    B frames: what ptxas reports for it."""
    from .decoder import qc_kernels as qk

    rows = {(r["kernel"], r["dtype"], r["width"], r["vec"]): r
            for r in qk.ptxas_cn_frames(report)}
    out = []
    for key in instantiations(dec, B):
        r = rows.get(key)
        out.append(f"{key[0]}<{key[1]}, width {key[2]}, {key[3]} frames a thread>: "
                   + (f"{r['registers']} registers, {r['stack']} B stack, "
                      f"{r['spill_stores'] + r['spill_loads']} B spills" if r
                      else "not in this build's report"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--code", nargs="+", default=["headline"],
                    choices=["headline", "peg", "qc", "dvbs2", "dvbs2-gather"])
    ap.add_argument("--dtype", default="both", choices=["int16", "float32", "both"])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_cn: needs a CUDA device", file=sys.stderr)
        return 1
    from .decoder import qc_kernels as qk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"# card {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    builds = qk.build_kernels(force=True)
    print("# kernel library built side by side: " + ", ".join(
        f"{unit} {b.seconds:.1f}s" for unit, b in builds.items()))
    report = "".join(b.report for b in builds.values())
    dev = torch.device("cuda")
    for code in args.code:
        profile(code, args, report, dev)
    print(smi)
    return 0


def profile(code: str, args, report: str, dev) -> None:
    import numpy as np
    import torch

    from . import bench, bench_n64800 as b64
    from .profile_vn import build_decoder

    B = args.batch or (bench.BATCH if code == "headline" else b64.BATCH)
    dtypes = (["float32"] if code.startswith("dvbs2") else
              ["int16", "float32"]) if args.dtype == "both" else [args.dtype]
    for dt in dtypes:
        dec = build_decoder(code, np.dtype(dt), dev, kernels=False)
        it = dec.spec.num_iters // 2
        for line in describe_instantiations(dec, B, report):
            print(f"#   ptxas {line}")
        bnd, by = cn_bound(dec, B)
        for width in (B, B - 3):
            m_vn = cn_input(dec, it, width)
            r = check_cn(dec, m_vn, reps=args.reps if width == B else max(2, args.reps // 4))
            print(f"# {code} {dt} B={width} it={it}: {r['name']} equal to the "
                  f"table-driven kernel and the plain version; frames {r['ms']:.4f} ms, "
                  f"table-driven {r['witness_ms']:.4f} ms"
                  + (f", unfolded route {r['unfolded_ms']:.4f} ms" if r["unfolded_ms"] else "")
                  + (f", bound {bnd:.4f} ms ({by}, {r['ms'] / bnd:.2f} x)" if width == B else "")
                  + f"; synd true {r['synd_true']}/{width}")
            del m_vn
        del dec
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
