"""ens2deg CLI: export a .ens ensemble as a node-perspective .deg degree
file for the PEG code generator (mirrors the reference's prog/ens2deg.cpp;
a copy of lut_ldpc_tpu/cli/ens2deg.py on the port's own modules)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ens2deg", description=__doc__)
    ap.add_argument("ens", help="input .ens ensemble file")
    ap.add_argument("deg", help="output .deg degree file")
    args = ap.parse_args(argv)

    from ..core.ensemble import LDPCEnsemble

    ens = LDPCEnsemble.read(args.ens)
    ens.export_deg(args.deg)
    print(f"Wrote {args.deg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
