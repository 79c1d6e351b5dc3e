"""reuse_vec_opt CLI: greedy LUT-reuse-pattern optimization (port of
lut_ldpc_tpu/cli/reuse_vec_opt.py).

Mirrors the reference's prog/reuse_vec_opt.cpp: starting from an initial
reuse vector, repeatedly try setting reuse=1 at every free iteration (all
candidates evolved in parallel), keep the candidate with the smallest final
error probability, and scale the design noise down when no candidate meets
the Pe target — until the number of distinct LUT stages reaches the target.
--accel TOPK pre-ranks every candidate of a round in one batched float32
loop on --device (default cuda; CUDA asked for where there is none raises).

    python -m lut_ldpc_torch.cli.reuse_vec_opt -m -t 0.82 -i 30 -r 10 -d "3 / 1.0 / 6 / 1.0"
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MAX_LLR_MAGNITUDE = 25.0
MAX_BISEC_ITER = 50
NQ_FINE = 5000
PE_MAX = 1e-17
THR_PREC = 1e-7


def parse_degree_dist(tokens: list[str]):
    """'VN_degrees / VN_probabilities / CN_degrees / CN_probabilities'."""
    from ..core.ensemble import LDPCEnsemble

    parts = " ".join(tokens).split("/")
    if len(parts) != 4:
        raise SystemExit("degree-dist needs 4 '/'-separated groups")
    dl = np.array([int(x) for x in parts[0].split()], dtype=np.int64)
    lam = np.array([float(x) for x in parts[1].split()])
    dr = np.array([int(x) for x in parts[2].split()], dtype=np.int64)
    rho = np.array([float(x) for x in parts[3].split()])
    return LDPCEnsemble(dl, lam, dr, rho)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="reuse_vec_opt", description=__doc__)
    ap.add_argument("-m", "--min-approx", action="store_true",
                    help="approximate check node updates (min-LUT)")
    ap.add_argument("--quant-bits-msg", type=int, default=4)
    ap.add_argument("--quant-bits-cha", type=int, default=4)
    ap.add_argument("-t", "--threshold", type=float, required=True,
                    help="noise value to run DE at")
    ap.add_argument("-e", "--ensemble", default="", help="initial ensemble file")
    ap.add_argument("-i", "--iterations", type=int, default=100)
    ap.add_argument("-d", "--degree-dist", nargs="+", default=None,
                    help='"VN_degrees / VN_probs / CN_degrees / CN_probs"')
    ap.add_argument("-s", "--scale-down", type=float, default=0.995)
    ap.add_argument("-p", "--pmax", type=float, default=1e-11)
    ap.add_argument("-r", "--reuse-stages", type=int, required=True,
                    help="number of distinct LUT stages")
    ap.add_argument("-v", "--reuse-vec", nargs="+", type=int, default=None)
    ap.add_argument("--lut-table-design", default="joint_root")
    ap.add_argument("--lut-tree-design", default="auto_bin_balanced")
    ap.add_argument("--accel", type=int, default=0, metavar="TOPK",
                    help="pre-rank all candidates per round on the "
                    "device (batched f32 DE, design/de_lut_gpu.py) and "
                    "evaluate only the TOPK best on the f64 host")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the --accel pre-ranking "
                         "(cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)

    from ..core.ensemble import LDPCEnsemble
    from ..design.de import ARI, DELut
    from ..design.templates import get_lut_tree_templates

    if args.ensemble:
        ens = LDPCEnsemble.read(args.ensemble)
    elif args.degree_dist:
        ens = parse_degree_dist(args.degree_dist)
    else:
        raise SystemExit("provide --ensemble or --degree-dist")
    print(f"Ensemble rate {ens.rate():g}")

    maxiter = args.iterations
    Nq_Cha = 2**args.quant_bits_cha
    Nq_Msg_vec = np.full(maxiter, 2**args.quant_bits_msg, dtype=np.int64)
    var_luts, chk_luts = get_lut_tree_templates(
        args.lut_tree_design, ens, Nq_Msg_vec, Nq_Cha, args.min_approx
    )
    if args.reuse_vec is None:
        reuse_vec = np.zeros(maxiter, dtype=bool)
    else:
        if len(args.reuse_vec) != maxiter:
            raise SystemExit("initial reuse vec dimension mismatch")
        reuse_vec = np.array(args.reuse_vec, dtype=bool)
        print(f"Provided initial reuse_vec = {reuse_vec.astype(int).tolist()}")

    def make_de(rv):
        return DELut(
            ens, Nq_Cha, Nq_Msg_vec, maxiter, var_luts,
            chk_luts if not args.min_approx else None, rv,
            THR_PREC, PE_MAX, ARI, MAX_BISEC_ITER,
            MAX_LLR_MAGNITUDE, NQ_FINE, args.lut_table_design,
        )

    def evolve_candidate(rv, thr):
        """(final Pe, first iteration reaching Pe target or maxiter)."""
        de = make_de(rv)
        _, _, Pe_trace, _, _ = de.evolve(thr, var_trace=True)
        Pe = float(Pe_trace[-1]) if len(Pe_trace) else 1.0
        hit = np.nonzero(Pe_trace < args.pmax)[0]
        iters = int(hit[0]) if len(hit) else maxiter
        return Pe, iters

    thr = args.threshold
    init_reuse = int(reuse_vec.sum())
    num_reuse = maxiter - init_reuse - args.reuse_stages
    print(f"Starting optimization. Initial reuse stages = {init_reuse}, "
          f"target number of stages = {args.reuse_stages}, "
          f"stages being added = {num_reuse}")

    accel = None
    if args.accel:
        if (args.min_approx
                and args.lut_table_design in ("individual", "joint_root")
                and args.lut_tree_design in ("auto_bin_balanced",
                                             "auto_bin_high")):
            from ..design.de_lut_gpu import DELutGPU

            accel = DELutGPU(
                ens, Nq_Cha, 2**args.quant_bits_msg, maxiter_de=maxiter,
                Pe_max=args.pmax, max_ni_de_iters=1,
                LLR_max=MAX_LLR_MAGNITUDE, Nq_fine=NQ_FINE,
                tree_mode=args.lut_tree_design, strategy=args.lut_table_design,
                device=device)
        else:
            print("accel pre-ranking needs min-LUT + individual/joint_root; "
                  "falling back to host evaluation")

    jj = 0
    while jj < num_reuse:
        candidates = [ii for ii in range(1, maxiter) if not reuse_vec[ii]]
        rvs = []
        for ii in candidates:
            rv = reuse_vec.copy()
            rv[ii] = True
            rvs.append(rv)
        all_candidates, all_rvs = candidates, rvs
        it_f32 = None
        if accel is not None and len(rvs) > args.accel:
            # one batched f32 loop ranks every candidate; the f64 host
            # confirms only the TOPK best (ranking matches the host —
            # tests/test_torch_de_lut.py — while Pe values differ in the tail)
            Pe_f32, it_f32 = accel.prerank_reuse(thr, np.stack(rvs), args.pmax)
            order = np.argsort(Pe_f32, kind="stable")
            keep = sorted(order[: args.accel].tolist())
            candidates = [candidates[i] for i in keep]
            rvs = [rvs[i] for i in keep]

        def host_eval(rvs_):
            with ThreadPoolExecutor(max_workers=16) as pool:
                res = list(pool.map(lambda rv: evolve_candidate(rv, thr), rvs_))
            return (np.array([r[0] for r in res]),
                    np.array([r[1] for r in res]))

        Pe_vec, iter_vec = host_eval(rvs)
        if (it_f32 is not None and iter_vec.min() == maxiter
                and int(it_f32.min()) < maxiter):
            # top-k missed the Pe target but the f32 pass says some other
            # candidate reached it: confirm with a full host round before
            # scaling the threshold down
            candidates, rvs = all_candidates, all_rvs
            Pe_vec, iter_vec = host_eval(rvs)
        if iter_vec.min() == maxiter:
            thr *= args.scale_down
            print(f"Could not reach Pe target, scaling down to thr = {thr:g}")
            continue
        best = candidates[int(np.argmin(Pe_vec))]
        reuse_vec[best] = True
        jj += 1
        print(f"Reached Pe target within {iter_vec.min()} iterations.")
        print(f"Reuse stage {jj}, Adding idx = {best}")
        print(f"reuse_vec = {reuse_vec.astype(int).tolist()}")

    print("Finished.")
    print(f"reuse_vec = {reuse_vec.astype(int).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
