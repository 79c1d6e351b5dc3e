"""The per-degree-block kernels against their plain versions, with times.

Counterpart of examples/profile_pallas.py for ``cn_block_pass`` and
``vn_block_pass`` (lut_ldpc_torch/decoder/block_kernels.py):

    python -m lut_ldpc_torch.profile_kernels [B] [--dtype int16|float32|both]
        [--chain 32] [--code headline|peg]

The headline codec (lut_ldpc_torch.bench; its CN block d=6 x 5000 checks
and VN block d=3 x 10000 variables) or the N=64800 PEG codec
(lut_ldpc_torch.bench_n64800; VN degrees 2, 3, 9, 17, CN 8, 9, 10), its
prefix spec in the chosen dtype on the per-degree-block loop, at B frames
(default 4096) and at B - 3 (one frame a thread), inputs drawn from the
value tables of a middle iteration with ``np.random.default_rng(0)``.  The
CN block kernel must equal its plain version (values on the real rows,
syndrome); the generated VN block kernel must equal its plain version, the
table-driven kernel (``generic=True``) and the generated std class kernel of
the same spec on the same planes (values, bits, unanimity).  Then
CUDA-event times of a single call and of --chain chained calls (each call's
output the next one's input, the way a decode runs them), the witness's and
the std class kernel's times, the plain version's time and the card's bound
for the same work.

Needs a CUDA device.  Prints the card's name and power limit first.
``check_blocks`` is the part ``chip_smoke.py`` shares.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores, same sheet
CN_OPS_PER_EDGE = 13       # two-min + parity in, select + sign out


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of fn over `reps` calls after one warm-up
    call, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int, ops: int):
    """(ms, "bytes" | "operations"): the larger of bytes over the memory
    rate and float32 operations over the float32 rate."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def vn_block_ops(prog) -> int:
    """Float32 operations of one node and frame in ``vn_block_pass`` as the
    generated program evaluates it: per step its operand adds (a total minus
    self: one subtraction, the total's d - 1 adds once), a compare and a
    select per threshold and three for the tie; one sign compare per
    output."""
    ops, tot = prog.degree, 0
    for st in prog.program.steps:
        op = prog.ops[st.op]
        if st.minus is not None:
            ops, tot = ops + 1, prog.degree - 1
        else:
            ops += len(st.operands) - 1
        ops += 2 * op.nthr + 3
    return ops + tot


def _std_class(dec, bi, m3, cha, it, n_real):
    """The generated std class kernel of `dec`'s spec, class bi, on the
    planes of one block: (out, bits, unan)."""
    import torch

    from .decoder import qc_kernels as qk
    from .decoder import vn_codegen

    d, n, B = m3.shape
    out = torch.empty_like(m3)
    bits = torch.empty((n, B), dtype=torch.int8, device=m3.device)
    unan = torch.ones(B, dtype=torch.bool, device=m3.device)
    fn = vn_codegen.library(dec.params, dec.dtype, "std").handle().lut_vn_std_class
    err = fn(bi, m3.data_ptr(), cha.data_ptr(), out.data_ptr(), bits.data_ptr(),
             unan.data_ptr(), 0, n, n_real, 0, B, qk._aligned(m3, cha, out, bits),
             qk._prm_row(dec.params, it), qk._stream(m3.device))
    qk._raise_on(err, "vn_std_class")
    return out, bits, unan


def check_blocks(dec, it: int, B: int, seed: int = 0, reps: int = 20,
                 chain: int = 0, plain_reps: int = 2):
    """Every CN and VN degree block of the block-loop decoder `dec`
    (``ArithLUTDecoder(..., loop="blocks")`` on a CUDA device) at iteration
    `it` and B frames: the CN block kernel against its plain version, the
    generated VN block kernel against its plain version, the table-driven
    kernel and the generated std class kernel of the spec on the same
    planes; raises AssertionError on any difference.  Returns one dict per
    block: kind ("cn" | "vn"), degree, n_real, n_pad, max_abs_err, ms,
    chain_ms (None unless chain > 0), plain_ms (None unless plain_reps),
    bound_ms, bound_by, and for VN blocks witness_ms and std_ms."""
    import numpy as np
    import torch

    from .decoder import block_kernels as bk
    from .decoder.hybrid import root_levels

    if dec.loop != "blocks":
        raise ValueError("check_blocks needs a block-loop decoder")
    dev, size = dec.device, dec.dtype.itemsize
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(root_levels(dec.spec, it), device=dev).to(dec.dtype)
    leaf = torch.as_tensor(np.asarray(dec.spec.leaf_cha), device=dev).to(dec.dtype)

    def draw(tab, shape):
        return tab[torch.as_tensor(rng.integers(0, len(tab), shape), device=dev)]

    def err(a, b):
        return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0

    def chained(step, m):
        def run():
            x = m
            for _ in range(chain):
                x = step(x)
        return cuda_ms(run, 3) / chain if chain else None

    def plain(fn):
        return cuda_ms(fn, plain_reps) if plain_reps else None

    out = []
    for blk in dec.layout.cn_blocks:
        d, n, nr = blk.degree, blk.n_pad, blk.num_nodes
        m3 = draw(table, (d, n, B))
        o_k, s_k = bk.cn_block_pass(m3, nr)
        o_p, s_p = bk.cn_block_pass_ref(m3, nr)
        torch.cuda.synchronize()
        e = err(o_k[:, :nr], o_p[:, :nr])
        if e != 0 or not torch.equal(s_k, s_p):
            raise AssertionError(f"cn_block_pass d={d} disagrees with its plain "
                                 f"version (max err {e})")
        del o_k, o_p
        b_ms, b_by = bound_ms(2 * d * nr * B * size + B, CN_OPS_PER_EDGE * d * nr * B)
        out.append(dict(
            kind="cn", degree=d, n_real=nr, n_pad=n, max_abs_err=e,
            ms=cuda_ms(lambda: bk.cn_block_pass(m3, nr), reps),
            chain_ms=chained(lambda x: bk.cn_block_pass(x, nr)[0], m3),
            plain_ms=plain(lambda: bk.cn_block_pass_ref(m3, nr)),
            bound_ms=b_ms, bound_by=b_by, synd_true=int(s_k.sum())))
        del m3
    for bi, (blk, prog) in enumerate(zip(dec.layout.vn_blocks, dec._progs)):
        d, n, nr = blk.degree, blk.n_pad, blk.num_nodes
        m3, cha = draw(table, (d, n, B)), draw(leaf, (n, B))
        o_k, b_k, u_k = bk.run_vn_block(m3, cha, prog, it, nr)
        e = 0.0
        for what, fn in (
                ("its plain version", lambda: bk.run_vn_block_ref(m3, cha, prog, it, nr)),
                ("the table-driven kernel",
                 lambda: bk.run_vn_block(m3, cha, prog, it, nr, generic=True)),
                ("the generated std class kernel",
                 lambda: _std_class(dec, bi, m3, cha, it, nr))):
            o_w, b_w, u_w = fn()
            torch.cuda.synchronize()
            e = max(e, err(o_k[:, :nr], o_w[:, :nr]))
            if (e != 0 or not torch.equal(b_k[:nr].view(torch.int8), b_w[:nr].view(torch.int8))
                    or not torch.equal(u_k, u_w)):
                raise AssertionError(f"vn_block_pass d={d} disagrees with {what} "
                                     f"(max err {e})")
            del o_w
        del o_k
        b_ms, b_by = bound_ms((2 * d + 1) * nr * B * size + nr * B + B,
                              vn_block_ops(prog) * nr * B)
        out.append(dict(
            kind="vn", degree=d, n_real=nr, n_pad=n, max_abs_err=e,
            ms=cuda_ms(lambda: bk.run_vn_block(m3, cha, prog, it, nr), reps),
            chain_ms=chained(lambda x: bk.run_vn_block(x, cha, prog, it, nr)[0], m3),
            witness_ms=cuda_ms(lambda: bk.run_vn_block(m3, cha, prog, it, nr, generic=True),
                               max(1, reps // 4)),
            std_ms=cuda_ms(lambda: _std_class(dec, bi, m3, cha, it, nr), reps),
            plain_ms=plain(lambda: bk.run_vn_block_ref(m3, cha, prog, it, nr)),
            bound_ms=b_ms, bound_by=b_by, unan_true=int(u_k.sum())))
        del m3, cha
    return out


def describe(r, dtype_name: str, B: int) -> str:
    chain = "" if r["chain_ms"] is None else f", chained {r['chain_ms']:.4f} ms a call"
    plain = "" if r["plain_ms"] is None else f", plain {r['plain_ms']:.3f} ms"
    vn = ("" if r["kind"] == "cn" else
          f", table-driven {r['witness_ms']:.4f} ms, std class kernel {r['std_ms']:.4f} ms")
    return (f"{r['kind']}_block_pass {dtype_name} d={r['degree']} n={r['n_real']} "
            f"(padded {r['n_pad']}) B={B}: equal to "
            + ("its plain version" if r["kind"] == "cn" else
               "its plain version, the table-driven kernel and the std class kernel")
            + f"; single call {r['ms']:.4f} ms{chain}{vn}{plain}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def block_decoder(code: str, dtype, dev):
    """The block-loop ArithLUTDecoder of `code` ("headline" or "peg") on its
    prefix spec in `dtype`, with the generated std unit of the same spec
    started beside its block unit."""
    import numpy as np

    from . import bench, bench_n64800 as b64
    from .decoder import ArithLUTDecoder, build_arith_prefix_spec, vn_codegen

    codec = bench.build_codec() if code == "headline" else b64.build_codec(code)
    spec = build_arith_prefix_spec(codec, dtype=np.dtype(dtype).type)
    dec = ArithLUTDecoder(codec, "cpu", spec=spec, loop="blocks")
    vn_codegen.start_build(dec.params, dec.dtype, "std")
    return ArithLUTDecoder(codec, dev, spec=spec, loop="blocks")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=4096)
    ap.add_argument("--dtype", default="both", choices=["int16", "float32", "both"])
    ap.add_argument("--chain", type=int, default=32)
    ap.add_argument("--code", default="headline", choices=["headline", "peg"])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("lut_ldpc_torch.profile_kernels needs a CUDA device")
    print("# card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    names = ["int16", "float32"] if args.dtype == "both" else [args.dtype]
    for name in names:
        dec = block_decoder(args.code, name, "cuda")
        it = dec.S // 2
        print(f"# {args.code} {name} prefix spec S={dec.S}, iteration {it}")
        for B in (args.batch, args.batch - 3):
            for r in check_blocks(dec, it, B, chain=args.chain if B == args.batch else 0,
                                  plain_reps=2 if B == args.batch else 0):
                print("# " + describe(r, name, B))


if __name__ == "__main__":
    main()
