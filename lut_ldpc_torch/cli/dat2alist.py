"""dat2alist CLI: convert a PEG compressed-H .dat file to .alist.

Format (mirrors the reference's prog/dat2alist.cpp): line 1 = N, line 2 =
M, line 3 = max row weight, then M rows of 1-based variable indices (0 =
padding).  A copy of lut_ldpc_tpu/cli/dat2alist.py on the port's own
modules.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dat2alist", description=__doc__)
    ap.add_argument("dat", help="input .dat (PEG compressed H)")
    ap.add_argument("alist", help="output .alist")
    args = ap.parse_args(argv)

    from ..core.alist import write_alist

    with open(args.dat) as f:
        N = int(f.readline().split()[0])
        M = int(f.readline().split()[0])
        max_col = int(f.readline().split()[0])
        H = np.zeros((M, N), dtype=np.uint8)
        for mm in range(M):
            row = [int(x) for x in f.readline().split()[:max_col]]
            for nn in row:
                if nn > 0:
                    H[mm, nn - 1] = 1
    write_alist(args.alist, H)
    print(f"Wrote {args.alist}: N={N} M={M}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
