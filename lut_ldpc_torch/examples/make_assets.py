"""Generate the repo's data assets with the port's own tools (port of
examples/make_assets.py).

Writes, under --out: ensembles/ (degree distributions, the ensemble
writer of core/ensemble.py), codes/ (PEG alists from core/peg.py, built
from csrc/peg.cpp, and the two quasi-cyclic .qc.json of core/qc.py) and
trees/ (render_tree_example).  Files that exist are kept.  With the same
seeds these are the files the repo ships in ensembles/, codes/ and trees/.
The DVB-S2 standard matrix is data, not designable: it is imported from a
checkout of the reference toolchain given with --reference, and skipped
without one.

    python -m lut_ldpc_torch.examples.make_assets [--out results/assets]
        [--big] [--reference DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import RESULTS

PEG_SEED = 20260817
# Published BIAWGN-optimized irregular rate-1/2 ensembles (Richardson,
# Shokrollahi & Urbanke 2001, tables II/III, the distributions the
# reference ships, ensembles/README.md), keyed by file name; and the
# LUT-q4-optimized distribution with maximum VN degree 8 (Meidlinger &
# Matz; the reference's ensembles/rate0.50_dv02-08_dc07-08_lut_q4.ens)
PUBLISHED = {
    "rate0.50_dv02-04_dc05-06.ens": (
        [2, 3, 4], [0.38354, 0.04237, 0.57409], [5, 6], [0.24123, 0.75877]),
    "rate0.50_dv02-05_dc06-07.ens": (
        [2, 3, 4, 5], [0.32660, 0.11960, 0.18393, 0.36988], [6, 7], [0.78555, 0.21445]),
    "rate0.50_dv02-08_dc06-07.ens": (
        [2, 3, 8], [0.30013, 0.28395, 0.41592], [6, 7], [0.22919, 0.77081]),
    "rate0.50_dv02-11_dc07-08.ens": (
        [2, 3, 4, 11], [0.23882, 0.29515, 0.03261, 0.43342], [7, 8], [0.43011, 0.56989]),
    "rate0.50_dv02-15_dc08-09.ens": (
        [2, 3, 4, 5, 7, 14, 15],
        [0.23802, 0.20997, 0.03492, 0.12015, 0.01587, 0.0048, 0.37627],
        [8, 9], [0.98013, 0.01987]),
    "rate0.50_dv02-50_dc09-11.ens": (
        [2, 3, 4, 7, 8, 9, 10, 15, 30, 50],
        [0.17120, 0.21053, 0.00273, 0.00009, 0.15269, 0.09227, 0.02802, 0.01206,
         0.07212, 0.25830],
        [9, 10, 11], [0.3362, 0.08883, 0.57497]),
    "rate0.50_dv02-08_dc07-08_lut_q4.ens": (
        [2, 3, 8], [0.163844, 0.40637, 0.429786], [7, 8], [0.591665, 0.408335]),
}


def _ensemble(dv, lam, dc, rho):
    from ..core.ensemble import LDPCEnsemble

    return LDPCEnsemble(np.array(dv), np.array(lam), np.array(dc), np.array(rho))


def make_assets(out: str, big: bool = False, reference: str | None = None) -> None:
    """Write ensembles/, codes/ and trees/ under `out` (see the module
    docstring); `big` adds the N=10000 and second N=64800 PEG codes (about
    2 h of PEG for the latter)."""
    from ..core.alist import write_alist
    from ..core.peg import peg_code_from_ensemble
    from ..core.qc import qc_expand, qc_generate_irregular, qc_generate_regular, save_qc

    ens_dir, codes_dir = os.path.join(out, "ensembles"), os.path.join(out, "codes")
    os.makedirs(ens_dir, exist_ok=True)
    os.makedirs(codes_dir, exist_ok=True)

    # --- ensembles ---------------------------------------------------------
    ens36 = _ensemble([3], [1.0], [6], [1.0])  # regular (3,6), rate 1/2
    ens36.write(os.path.join(ens_dir, "rate0.50_dv03_dc06.ens"))
    # the published 4-bit min-LUT design point dv {2,3,9,17} / dc {8,9}
    # (Meidlinger & Matz; the reference's worked example, DE threshold
    # sigma* = 0.929193)
    ens_irr = _ensemble([2, 3, 9, 17], [0.138045, 0.401038, 0.026586, 0.434331],
                        [8, 9], [0.323376, 0.676624])
    ens_irr.write(os.path.join(ens_dir, "rate0.50_dv02-17_dc08-09_lut_q4.ens"))
    ens1032 = _ensemble([6], [1.0], [32], [1.0])  # 10GBase-T style (6,32)
    ens1032.write(os.path.join(ens_dir, "rate0.84_dv06_dc32.ens"))
    for name, dist in PUBLISHED.items():
        _ensemble(*dist).write(os.path.join(ens_dir, name))

    # --- DVB-S2 rate-1/2 N=64800 (ETSI EN 302 307): imported, normalized ---
    out_dvbs2 = os.path.join(codes_dir, "rate0.50_irreg_dvbs2_N64800.alist")
    ref_dvbs2 = reference and os.path.join(reference, "codes",
                                           "rate0.50_irreg_dvbs2_N64800.alist")
    if ref_dvbs2 and os.path.exists(ref_dvbs2) and not os.path.exists(out_dvbs2):
        from ..core.alist import read_alist
        from ..core.tanner import TannerGraph

        print("importing DVB-S2 N=64800 standard matrix ...", flush=True)
        g = TannerGraph.from_dense(read_alist(ref_dvbs2))
        assert g.nvar == 64800 and g.nchk == 32400
        write_alist(out_dvbs2, g.to_dense())

    # --- quasi-cyclic codes (girth 8; decode permutations are cyclic rolls) --
    qc36 = os.path.join(codes_dir, "rate0.50_dv03_dc06_N10000_qc.qc.json")
    if not os.path.exists(qc36):
        print("QC: (3,6) N=10000 ...", flush=True)
        save_qc(qc36, qc_generate_regular(3, 6, Z=1000, nb=10, seed=1))
    qcirr = os.path.join(codes_dir, "rate0.50_dv02-17_dc08-09_N64800_qc.qc.json")
    if not os.path.exists(qcirr):
        # Z=720, nb=90, mb=45: rate exactly 1/2; node-perspective degree
        # fractions quantize to [27, 52, 1, 10]/90 for dv {2, 3, 9, 17} and
        # the check blocks to [16, 29]/45 for dc {8, 9}
        print("QC: irregular dv02-17 N=64800 ...", flush=True)
        qc = qc_generate_irregular(ens_irr, Z=720, nb=90, seed=3, mb=45)
        g = qc_expand(qc)
        assert g.nvar == 64800 and g.nchk == 32400
        save_qc(qcirr, qc)

    # --- PEG codes ---------------------------------------------------------
    jobs = [
        (ens36, 500, 1000, "rate0.50_dv03_dc06_N1000.alist"),
        (ens_irr, 250, 500, "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist"),
        (ens1032, 384, 2048, "rate0.84_reg_v6c32_N2048.alist"),
        (ens_irr, 500, 1000, "rate0.50_dv02-17_dc08-09_lut_q4_N1000.alist"),
    ]
    if big:
        ens_15 = _ensemble(*PUBLISHED["rate0.50_dv02-15_dc08-09.ens"])
        ens_dv08 = _ensemble(*PUBLISHED["rate0.50_dv02-08_dc07-08_lut_q4.ens"])
        jobs += [
            (ens36, 5000, 10000, "rate0.50_dv03_dc06_N10000.alist"),
            (ens_15, 5000, 10000, "rate0.50_dv02-15_dc08-09_N10000.alist"),
            (ens_irr, 5000, 10000, "rate0.50_dv02-17_dc08-09_lut_q4_N10000.alist"),
            # the reference's second shipped N=64800 LUT design point
            (ens_dv08, 32400, 64800, "rate0.50_dv02-08_dc07-08_lut_q4_N64800.alist"),
        ]
    for ens, M, N, name in jobs:
        path = os.path.join(codes_dir, name)
        if os.path.exists(path):
            print(f"PEG: {name} exists, skipping", flush=True)
            continue
        print(f"PEG: {name} ...", flush=True)
        graph, lg = peg_code_from_ensemble(ens, M, N, seed=PEG_SEED)
        write_alist(path, graph.to_dense())
        finite = lg[lg > 0]
        print(f"  N={N} M={M} edges={graph.num_edges} "
              f"girth={'inf' if not len(finite) else int(finite.min())}")

    # --- rendered tree example (reference trees/example.{tikz,png}) --------
    trees = os.path.join(out, "trees")
    if not os.path.exists(os.path.join(trees, "example.tikz")):
        from .render_tree_example import render

        render(trees)
    print(f"Assets written to {out}/ensembles, codes and trees")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(RESULTS, "assets"))
    ap.add_argument("--big", action="store_true", help="also build the N=10000 codes "
                    "and the second N=64800 code (slower)")
    ap.add_argument("--reference", default=None,
                    help="checkout of the reference toolchain to import the DVB-S2 "
                         "matrix from")
    args = ap.parse_args(argv)
    make_assets(args.out, args.big, args.reference)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
