"""ber_sim CLI: INI-driven Monte-Carlo BER simulation (port of
lut_ldpc_tpu/cli/ber_sim.py).

Mirrors the reference's prog/ber_sim.cpp: -p/--params INI file, -s/--seed,
-b/--basedir, -c/--custom-name; the presence of a [LUT] vs [BP] section
selects the decoder family.  --device names the device (default cuda; a
CPU run is asked for with --device cpu, and CUDA asked for where there is
none raises).  --mesh N runs data-parallel over N slots of that device type
(N CPU slots for --device cpu, cards cuda:0 .. cuda:N-1 for cuda, which
raises where fewer exist; one process drives its cards at once, a host
thread each); under torchrun, which sets RANK, WORLD_SIZE and MASTER_ADDR,
the processes first join a gloo group, N counts the slots of all of them,
and each rank makes its first card the current device before it builds
anything.  Rank 0 writes the same files as a one-card run: the seed decides
every batch:

    python -m lut_ldpc_torch.cli.ber_sim -p params/ber.ini.bp.example -s 0
    torchrun --nproc_per_node 4 -m lut_ldpc_torch.cli.ber_sim -p <ini> --mesh 4

Results land in <results_dir>/<prefix>_N..._R..._maxIter..._zcw..._frames...
as npz + JSON and as the reference's .it file, with a copy of the params
file beside them, under the JAX CLI's file names.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys


def gen_filename(cfg, nvar: int, rate: float, custom: str = "") -> str:
    """Results directory/file base name (LDPC_BER_Sim.cpp:104-115)."""
    max_iter = cfg.lut.max_iter if cfg.lut is not None else cfg.bp.max_iter
    name = (
        f"{cfg.sim.results_prefix}_N{nvar}_R{rate:g}_maxIter{max_iter}"
        f"_zcw{int(cfg.ldpc.zero_codeword)}_frames{cfg.sim.Nframes}"
    )
    if cfg.lut is not None and cfg.lut.min_lut:
        name += "_minLUT"
    return name + cfg.sim.custom_name + custom


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ber_sim", description=__doc__)
    ap.add_argument("-p", "--params", required=True, help="input parameter file (INI)")
    ap.add_argument("-s", "--seed", type=int, default=0, help="random seed")
    ap.add_argument("-b", "--basedir", default=os.getcwd(),
                    help="paths in params files are relative to this directory")
    ap.add_argument("-c", "--custom-name", default="",
                    help="append this string to the results file name")
    ap.add_argument("--device", default="cuda",
                    help="torch device to simulate on (cuda, cuda:N or cpu)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="data-parallel over N slots of --device's type (0 = one device)")
    args = ap.parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..parallel import dp_mesh, multihost_init
    from ..sim import parse_ini, run_from_config

    multihost_init()
    cfg = parse_ini(args.params)
    mesh = dp_mesh(args.mesh, args.device) if args.mesh else None
    first = mesh.devices[0] if mesh is not None else resolve_device(args.device)
    if first.type == "cuda":
        torch.cuda.set_device(first)  # torch's own allocations and events go there
    results, sim = run_from_config(cfg, None if mesh else args.device,
                                   codes_root=args.basedir, seed=args.seed, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return 0  # every rank holds the same counters: rank 0 writes them

    out_base = gen_filename(cfg, sim.graph.nvar, sim.rate, args.custom_name)
    out_dir = os.path.join(args.basedir, cfg.sim.results_dir, out_base)
    os.makedirs(out_dir, exist_ok=True)
    seed_eff = args.seed + cfg.sim.rand_seed_offset
    out_path = os.path.join(out_dir, f"{out_base}_rseed{seed_eff:04d}.npz")
    results.save(out_path)
    # also write the reference's .it schema for the MATLAB analysis scripts
    results.save_itfile(out_path.removesuffix(".npz") + ".it")
    # copy the params file next to the results (LDPC_BER_Sim.cpp:331-338)
    params_copy = os.path.join(out_dir, os.path.basename(args.params))
    if not os.path.exists(params_copy):
        shutil.copyfile(args.params, params_copy)
    print(f"Done simulating. Runtime = {results.runtime:.2f} seconds")
    print(f"Results written to {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
