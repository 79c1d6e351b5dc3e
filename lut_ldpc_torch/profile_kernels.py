"""The per-degree-block kernels against their plain versions, with times.

Counterpart of examples/profile_pallas.py for ``cn_block_pass`` and
``vn_block_pass`` (lut_ldpc_torch/decoder/block_kernels.py):

    python -m lut_ldpc_torch.profile_kernels [B] [--dtype int16|float32|both]
        [--chain 32]

The headline codec (lut_ldpc_torch.bench), its prefix spec in the chosen
dtype, the spec's CN block (d=6, 5000 checks) and VN block (d=3, 10000
variables) at B frames (default 4096), inputs drawn from the value tables
of a middle iteration with ``np.random.default_rng(0)``.  Each kernel must
equal its plain version (values on the real rows, syndrome, bits,
unanimity); then CUDA-event times of a single call and of --chain chained
calls (each call's output the next one's input, the way a decode runs
them), the plain version's time and the card's bound for the same work.

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
    """Float32 operations of one node and frame in ``vn_block_pass``: the
    whole tree for each of the d outputs (an op costs its operand adds, a
    compare and a select per threshold and three for the tie), one sign
    compare per output."""
    tree = sum(len(op.operands) - 1 + 2 * op.nthr + 3 for op in prog.ops)
    return prog.degree * (tree + 1)


def check_blocks(dec, it: int, B: int, seed: int = 0, reps: int = 20,
                 chain: int = 0, plain_reps: int = 2):
    """Every CN and VN degree block of the block-loop decoder `dec`
    (``ArithLUTDecoder(..., loop="blocks")`` on a CUDA device) against its
    plain version at iteration `it` and B frames; raises AssertionError on
    any difference.  Returns one dict per block: kind ("cn" | "vn"), degree,
    n_real, n_pad, max_abs_err, ms, chain_ms (None unless chain > 0),
    plain_ms, bound_ms, bound_by."""
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
            plain_ms=cuda_ms(lambda: bk.cn_block_pass_ref(m3, nr), plain_reps),
            bound_ms=b_ms, bound_by=b_by, synd_true=int(s_k.sum())))
        del m3
    for blk, prog in zip(dec.layout.vn_blocks, dec._progs):
        d, n, nr = blk.degree, blk.n_pad, blk.num_nodes
        m3, cha = draw(table, (d, n, B)), draw(leaf, (n, B))
        o_k, b_k, u_k = bk.run_vn_block(m3, cha, prog, it, nr)
        o_p, b_p, u_p = bk.run_vn_block_ref(m3, cha, prog, it, nr)
        torch.cuda.synchronize()
        e = err(o_k[:, :nr], o_p[:, :nr])
        if e != 0 or not torch.equal(b_k[:nr], b_p[:nr]) or not torch.equal(u_k, u_p):
            raise AssertionError(f"vn_block_pass d={d} disagrees with its plain "
                                 f"version (max err {e})")
        del o_k, o_p
        b_ms, b_by = bound_ms((2 * d + 1) * nr * B * size + nr * B + B,
                              vn_block_ops(prog) * nr * B)
        out.append(dict(
            kind="vn", degree=d, n_real=nr, n_pad=n, max_abs_err=e,
            ms=cuda_ms(lambda: bk.run_vn_block(m3, cha, prog, it, nr), reps),
            chain_ms=chained(lambda x: bk.run_vn_block(x, cha, prog, it, nr)[0], m3),
            plain_ms=cuda_ms(lambda: bk.run_vn_block_ref(m3, cha, prog, it, nr),
                             plain_reps),
            bound_ms=b_ms, bound_by=b_by, unan_true=int(u_k.sum())))
        del m3, cha
    return out


def describe(r, dtype_name: str) -> str:
    chain = "" if r["chain_ms"] is None else f", chained {r['chain_ms']:.4f} ms a call"
    return (f"{r['kind']}_block_pass {dtype_name} d={r['degree']} n={r['n_real']} "
            f"(padded {r['n_pad']}): equal to its plain version; single call "
            f"{r['ms']:.4f} ms{chain}, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=4096)
    ap.add_argument("--dtype", default="both", choices=["int16", "float32", "both"])
    ap.add_argument("--chain", type=int, default=32)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("lut_ldpc_torch.profile_kernels needs a CUDA device")
    from . import bench
    from .decoder import ArithLUTDecoder, build_arith_prefix_spec

    print("# card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    codec = bench.build_codec()
    names = ["int16", "float32"] if args.dtype == "both" else [args.dtype]
    for name in names:
        spec = build_arith_prefix_spec(codec, dtype=np.dtype(name).type)
        dec = ArithLUTDecoder(codec, "cuda", spec=spec, loop="blocks")
        it = spec.num_iters // 2
        print(f"# {name} prefix spec S={spec.num_iters}, iteration {it}, B={args.batch}")
        for r in check_blocks(dec, it, args.batch, chain=args.chain):
            print("# " + describe(r, name))


if __name__ == "__main__":
    main()
