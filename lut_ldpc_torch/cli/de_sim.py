"""de_sim CLI: density-evolution noise-threshold search (port of
lut_ldpc_tpu/cli/de_sim.py).

Mirrors the reference's prog/de_sim.cpp: an INI file with [Sim] plus either
a [LUT] or [BP] section; sweeps exactly one of {maxiter_de vector, qbits
rows, reuse_iter_vec} (LUT) or maxiter_de (BP); writes a human-readable
threshold report with lambda2-stability values.  Sweep points run in a
thread pool (the quantizer DP runs in native code and releases the GIL),
replacing the reference's one-std::thread-per-point fan-out.  With
`accelerator_sweep = 1` the batched float32 explorers
(design/de_lut_gpu.py, design/de_bp_gpu.py) narrow each search on
--device (default cuda; CUDA asked for where there is none raises) before
the f64 host bisection finishes inside their bracket; --mesh N shards the
LUT explorer's grids over N slots of --device's type (N cards for cuda,
which raises where fewer exist).

    python -m lut_ldpc_torch.cli.de_sim -p params/de.ini.example
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _parse_ivec(s: str) -> np.ndarray:
    s = s.strip().strip("[]")
    if not s:
        return np.zeros(0, dtype=np.int64)
    return np.array([int(float(x)) for x in s.replace(",", " ").split()], dtype=np.int64)


def _parse_imat(s: str) -> np.ndarray:
    rows = [r for r in s.strip().split(";") if r.strip()]
    return np.array([[int(float(x)) for x in r.split()] for r in rows], dtype=np.int64)


def _fmt_vec(v) -> str:
    return "[" + " ".join(f"{x:g}" for x in np.atleast_1d(v)) + "]"


def build_reuse_vec(maxiter_de: int, reuse_iters: int) -> np.ndarray:
    """Periodic reuse pattern: reuse_iters consecutive reuses then one fresh
    design, first/last iterations always fresh (prog/de_sim.cpp:231-247)."""
    reuse = np.zeros(maxiter_de, dtype=bool)
    tmp = 0
    for ii in range(1, maxiter_de - 1):
        if tmp < reuse_iters:
            reuse[ii] = True
            tmp += 1
        else:
            reuse[ii] = False
            tmp = 0
    return reuse


def de_sim_lut(cp, out, device="cuda", mesh_n: int = 0) -> None:
    from ..core.ensemble import LDPCEnsemble
    from ..design.de import ARI, DELut, get_lam2stable_lut
    from ..design.templates import get_lut_tree_templates
    from ..ops.pmf import rate_to_shannon_thr, sig2snr
    from ..sim.results import git_version

    def get(sec, key, default, cast=str):
        if cp.has_section(sec) and cp.has_option(sec, key):
            return cast(cp.get(sec, key).strip())
        return default

    ensemble_filename = get("Sim", "ensemble_filename", None)
    ens = LDPCEnsemble.read(ensemble_filename)
    print(f"Density evolution simulation for ensemble of Rate {ens.rate():g}")

    thr_min = get("Sim", "thr_min", 1e-9, float)
    thr_max = get("Sim", "thr_max", rate_to_shannon_thr(ens.rate()), float)
    thr_prec = get("Sim", "thr_prec", 1e-4, float)
    Pe_max = get("Sim", "Pe_max", 1e-9, float)
    maxiter_de_vec = get("Sim", "maxiter_de", np.array([1000]), _parse_ivec)
    maxiter_bisec = get("Sim", "maxiter_bisec", 50, int)
    max_ni_de_iters = get("Sim", "max_ni_de_iters", 30, int)
    LLR_max = get("Sim", "LLR_max", 25.0, float)
    results_name = get("Sim", "results_name", None)

    qbits = get("LUT", "qbits", np.array([[3, 3], [4, 4]]), _parse_imat)
    Nq_msg_vec_bits = get("LUT", "Nq_msg_vec", np.zeros(0, dtype=np.int64), _parse_ivec)
    reuse_iter_vec = get("LUT", "reuse_iter_vec", np.array([0]), _parse_ivec)
    reuse_vec_in = get("LUT", "reuse_vec", np.zeros(0, dtype=np.int64), _parse_ivec)
    min_lut = get("LUT", "min_lut", False, lambda s: s.lower() in ("1", "true", "yes"))
    tree_mode = get("LUT", "tree_mode", "auto_bin_balanced")
    Nq_fine = get("LUT", "Nq_fine", 5000, int)
    strategy = get("LUT", "irregular_design_strategy", "joint_root")

    # exactly one sweep dimension (prog/de_sim.cpp:170-183)
    if len(reuse_iter_vec) == 1 and qbits.shape[0] == 1 and len(maxiter_de_vec) >= 1:
        num = len(maxiter_de_vec)
        pick = lambda nn: (qbits[0, 0], qbits[0, 1], int(maxiter_de_vec[nn]),
                           int(reuse_iter_vec[0]))
    elif len(reuse_iter_vec) == 1 and len(maxiter_de_vec) == 1:
        num = qbits.shape[0]
        pick = lambda nn: (qbits[nn, 0], qbits[nn, 1], int(maxiter_de_vec[0]),
                           int(reuse_iter_vec[0]))
    elif len(maxiter_de_vec) == 1 and qbits.shape[0] == 1:
        num = len(reuse_iter_vec)
        pick = lambda nn: (qbits[0, 0], qbits[0, 1], int(maxiter_de_vec[0]),
                           int(reuse_iter_vec[nn]))
    else:
        raise SystemExit(
            "de_sim: sweeps over exactly one of qbits rows / maxiter_de / reuse_iter_vec"
        )

    des = []
    for nn in range(num):
        qb_cha, qb_msg, maxiter_de, reuse_iters = pick(nn)
        Nq_cha, Nq_msg = 2 ** int(qb_cha), 2 ** int(qb_msg)
        if len(Nq_msg_vec_bits) == maxiter_de:
            Nq_msg_v = 2 ** Nq_msg_vec_bits
        else:
            Nq_msg_v = np.full(maxiter_de, Nq_msg, dtype=np.int64)
        var_luts, chk_luts = get_lut_tree_templates(
            tree_mode, ens, Nq_msg_v, Nq_cha, min_lut
        )
        if len(reuse_vec_in):
            reuse_vec = reuse_vec_in.astype(bool)
        else:
            reuse_vec = build_reuse_vec(maxiter_de, reuse_iters)
        de = DELut(
            ens, Nq_cha, Nq_msg_v, maxiter_de, var_luts,
            chk_luts if not min_lut else None, reuse_vec,
            thr_prec, Pe_max, ARI, maxiter_bisec, LLR_max, Nq_fine, strategy,
        )
        de.set_bisec_window(thr_min, thr_max)
        de.set_exit_conditions(maxiter_de, maxiter_bisec, max_ni_de_iters,
                               Pe_max, thr_prec)
        des.append(de)

    accel = get("Sim", "accelerator_sweep", False,
                lambda s: s.lower() in ("1", "true", "yes"))
    if accel:
        # batched f32 grid evolution on the device narrows each search to
        # a tight bracket in a few batched loops; the f64 host bisection
        # finishes inside it (SURVEY §2 DE mapping).  The explorer covers
        # min-LUT and full-LUT binary-tree no-reuse configs; anything else
        # keeps the plain host search.
        explorable = (
            tree_mode in ("auto_bin_balanced", "auto_bin_high")
            and strategy in ("individual", "joint_root", "joint_level")
        )
        if explorable:
            from ..design.de_lut_gpu import DELutGPU

            for nn, de in enumerate(des):
                qb_cha, qb_msg, maxiter_de, reuse_iters = pick(nn)
                if reuse_iters or len(reuse_vec_in):
                    continue
                # Nq_Msg from the host engine's (possibly Nq_msg_vec-
                # overridden) resolution vector, not the qbits row;
                # non-uniform vectors run the explorer's segmented path
                mesh = None
                if mesh_n:
                    from ..parallel import dp_mesh

                    mesh = dp_mesh(mesh_n, device.type)
                tde = DELutGPU(
                    ens, 2 ** int(qb_cha), de.Nq_Msg_vec,
                    maxiter_de=maxiter_de, Pe_max=Pe_max,
                    max_ni_de_iters=max_ni_de_iters, LLR_max=LLR_max,
                    Nq_fine=Nq_fine, tree_mode=tree_mode, strategy=strategy,
                    min_lut=min_lut, device=None if mesh else device, mesh=mesh)
                tde.thr_min, tde.thr_max = thr_min, thr_max
                lo = tde.threshold(points=17, rounds=2)
                win = (thr_max - thr_min) / 16**2
                # widen downward: the f32 explorer (Pe floor 1e-6) sits
                # above the f64 threshold — up to ~0.025 sigma on some
                # irregular ensembles; a window that excludes the true
                # threshold makes the host bisection fail outright
                de.set_bisec_window(max(thr_min, lo - max(10 * win, 0.03)),
                                    min(lo + 2 * win, thr_max))
        else:
            print("de_sim: accelerator_sweep skipped (needs binary auto "
                  "trees and individual/joint_root strategy)")

    with ThreadPoolExecutor(max_workers=min(num, 16)) as pool:
        results = list(pool.map(lambda de: de.bisec_search(), des))
    bisec_iters = np.array([r[0] for r in results])
    thresholds = np.array([r[1] for r in results])

    lam2 = np.array([
        get_lam2stable_lut(
            thresholds[nn], ens.chk_degree_dist_dense(),
            2 ** int(pick(nn)[0]), 2 ** int(pick(nn)[1]), LLR_max, Nq_fine,
        )
        for nn in range(num)
    ])

    with open(results_name, "w") if out is None else _nullctx(out) as f:
        f.write(
            f"==== DE Threshold for ensemble file {ensemble_filename} "
            f"(Rate = {ens.rate():g}, BI-AWGN channel) \n"
            f"  Active Variable node degrees: {_fmt_vec(ens.degree_lam)}\n"
            f"  pmf of Variable node edges: {_fmt_vec(ens.lam)}\n"
            f"  Active Check node degrees: {_fmt_vec(ens.degree_rho)}\n"
            f"  pmf of Check node edges: {_fmt_vec(ens.rho)}\n"
            f"-- SIMULATION PARAMETERS"
            f"  Search Window = [{thr_min:g}, {thr_max:g}]\n"
            f"  Threshold precision = {thr_prec:g}\n"
            f"  Convergence error probability = {Pe_max:g}\n"
            f"  Maximum Number of message passing iterations = {_fmt_vec(maxiter_de_vec)}\n"
            f"  MinLut Algorithm used = {int(min_lut)}\n"
            f"  LUT Tree design mode = {tree_mode}\n"
            f"  LUT table design mode = {strategy}\n"
            f"  LUT reuse iter vec = {_fmt_vec(reuse_iter_vec)}\n"
            f"  Non improving iterations tolerated before terminating = {max_ni_de_iters}\n"
            f"  Resolutions [channel bits, message bits; ...] = {qbits.tolist()}\n"
            f"  Program git version = {git_version()}\n"
            f"  Bisection iterations until convergence = {_fmt_vec(bisec_iters)}\n"
            f"  Stable lam2 degrees at thresholds = {_fmt_vec(lam2)}\n"
            f"  Threshold(s) found = {_fmt_vec(thresholds)}\n"
            f"  Eb/N0 corresponding to thresholds = "
            f"{_fmt_vec(sig2snr(ens.rate(), thresholds))}\n\n"
        )
        if num == 1:
            print(f"Calculating Pe trace for threshold {thresholds[0]:g}")
            _, _, Pe_trace, _, _ = des[0].evolve(thresholds[0], var_trace=True)
            f.write(f"  Pe_trace = {_fmt_vec(Pe_trace)}\n")
    print(f"Threshold(s): {thresholds}")


def de_sim_bp(cp, out, device="cuda") -> None:
    from ..core.ensemble import LDPCEnsemble
    from ..design.de import get_lam2stable_cbp
    from ..design.de_bp import DEBp
    from ..ops.pmf import rate_to_shannon_thr, sig2snr
    from ..sim.results import git_version

    def get(sec, key, default, cast=str):
        if cp.has_section(sec) and cp.has_option(sec, key):
            return cast(cp.get(sec, key).strip())
        return default

    ensemble_filename = get("Sim", "ensemble_filename", None)
    ens = LDPCEnsemble.read(ensemble_filename)
    print(f"Density evolution simulation for ensemble of Rate {ens.rate():g}")

    thr_min = get("Sim", "thr_min", 1e-9, float)
    thr_max = get("Sim", "thr_max", rate_to_shannon_thr(ens.rate()), float)
    thr_prec = get("Sim", "thr_prec", 1e-4, float)
    Pe_max = get("Sim", "Pe_max", 1e-9, float)
    maxiter_de_vec = get("Sim", "maxiter_de", np.array([1000]), _parse_ivec)
    maxiter_bisec = get("Sim", "maxiter_bisec", 50, int)
    max_ni_de_iters = get("Sim", "max_ni_de_iters", 5, int)
    LLR_max = get("Sim", "LLR_max", 25.0, float)
    results_name = get("Sim", "results_name", None)
    Nq = get("BP", "qbits", 10, int)
    min_sum = get("BP", "min_sum", False, lambda s: s.lower() in ("1", "true", "yes"))
    if min_sum:
        raise SystemExit("de_sim: min-sum density evolution not implemented")

    des = []
    for nn in range(len(maxiter_de_vec)):
        de = DEBp(ens, Nq, LLR_max)
        de.set_bisec_window(thr_min, thr_max)
        de.set_exit_conditions(int(maxiter_de_vec[nn]), maxiter_bisec,
                               max_ni_de_iters, Pe_max, thr_prec)
        des.append(de)
    accel = get("Sim", "accelerator_sweep", False,
                lambda s: s.lower() in ("1", "true", "yes"))
    if accel:
        # batched f32 grid evolution on the device narrows each search to
        # a tight bracket in a few batched loops; the f64 host bisection
        # finishes inside it (SURVEY §2 DE mapping)
        from ..design.de_bp_gpu import DEBpGPU

        for nn, de in enumerate(des):
            tde = DEBpGPU(ens, Nq, LLR_max,
                          maxiter_de=int(maxiter_de_vec[nn]), Pe_max=Pe_max,
                          max_ni_de_iters=max_ni_de_iters, device=device)
            tde.host.set_bisec_window(thr_min, thr_max)
            lo = tde.threshold(points=17, rounds=2)
            win = (thr_max - thr_min) / 16**2
            # widen downward: the f32 explorer (Pe floor 1e-6) sits above
            # the f64 threshold — up to ~0.025 sigma on some irregular
            # ensembles; a window that excludes the true threshold makes
            # the host bisection fail outright
            de.set_bisec_window(max(thr_min, lo - max(10 * win, 0.03)),
                                min(lo + 2 * win, thr_max))
    with ThreadPoolExecutor(max_workers=min(len(des), 16)) as pool:
        results = list(pool.map(lambda de: de.bisec_search(), des))
    bisec_iters = np.array([r[0] for r in results])
    thresholds = np.array([r[1] for r in results])
    lam2 = np.array([
        get_lam2stable_cbp(t, ens.chk_degree_dist_dense()) for t in thresholds
    ])

    with open(results_name, "w") if out is None else _nullctx(out) as f:
        f.write(
            f"==== DE Threshold for ensemble file {ensemble_filename} "
            f"(Rate = {ens.rate():g}, BI-AWGN channel) \n"
            f"  Active Variable node degrees: {_fmt_vec(ens.degree_lam)}\n"
            f"  pmf of Variable node edges: {_fmt_vec(ens.lam)}\n"
            f"  Active Check node degrees: {_fmt_vec(ens.degree_rho)}\n"
            f"  pmf of Check node edges: {_fmt_vec(ens.rho)}\n"
            f"-- SIMULATION PARAMETERS\n"
            f"  Search Window = [{thr_min:g}, {thr_max:g}]\n"
            f"  Threshold precision = {thr_prec:g}\n"
            f"  Convergence error probability = {Pe_max:g}\n"
            f"  Maximum Number of message passing iterations = {_fmt_vec(maxiter_de_vec)}\n"
            f"  MinSum Approximation used = {int(min_sum)}\n"
            f"  Non improving iterations tolerated before terminating = {max_ni_de_iters}\n"
            f"  Resolution of discrete pmfs = {Nq} bit\n"
            f"  Maximum LLR magnitude = {LLR_max:g}\n"
            f"  Program git version = {git_version()}\n"
            f"  Bisection iterations until convergence = {_fmt_vec(bisec_iters)}\n"
            f"  Stable lam2 degrees at thresholds = {_fmt_vec(lam2)}\n"
            f"  Threshold(s) found = {_fmt_vec(thresholds)}\n"
            f"  Eb/N0 corresponding to thresholds = "
            f"{_fmt_vec(sig2snr(ens.rate(), thresholds))}\n\n"
        )
    print(f"Threshold(s): {thresholds}")


class _nullctx:
    def __init__(self, f):
        self.f = f

    def __enter__(self):
        return self.f

    def __exit__(self, *a):
        return False


def main(argv=None) -> int:
    import configparser

    ap = argparse.ArgumentParser(prog="de_sim", description=__doc__)
    ap.add_argument("-p", "--params", required=True, help="input parameter file")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the accelerator_sweep explorers "
                         "(cuda, cuda:N or cpu)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard accelerator_sweep grids over N slots of --device's "
                         "type (0 = one device)")
    args = ap.parse_args(argv)
    from ..device import resolve_device

    device = resolve_device(args.device)

    cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    cp.optionxform = str
    with open(args.params) as f:
        cp.read_string(f.read())
    if cp.has_section("LUT"):
        de_sim_lut(cp, None, device, mesh_n=args.mesh)
    elif cp.has_section("BP"):
        de_sim_bp(cp, None, device)
    else:
        raise SystemExit(
            "de_sim: the params file must contain a [LUT] or [BP] section"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
