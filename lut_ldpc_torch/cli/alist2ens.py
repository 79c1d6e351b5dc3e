"""alist2ens CLI: extract the empirical degree-distribution ensemble from a
parity-check matrix (mirrors the reference's prog/alist2ens.cpp; a copy of
lut_ldpc_tpu/cli/alist2ens.py on the port's own modules)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="alist2ens", description=__doc__)
    ap.add_argument("alist", help="input .alist parity-check matrix")
    ap.add_argument("ens", help="output .ens ensemble file")
    args = ap.parse_args(argv)

    from ..core.tanner import TannerGraph

    graph = TannerGraph.from_alist(args.alist)
    ens = graph.empirical_ensemble()
    ens.write(args.ens)
    print(f"Wrote {args.ens}: rate {ens.rate():.4f}, "
          f"var degrees {ens.degree_lam.tolist()}, chk degrees {ens.degree_rho.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
