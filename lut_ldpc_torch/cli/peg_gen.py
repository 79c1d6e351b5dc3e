"""peg_gen CLI: construct an LDPC code from an ensemble via PEG.

One-command equivalent of the reference's scripts/peg.sh pipeline
(ens2deg -> MainPEG -> dat2alist): reads a .ens ensemble, realizes the
node-perspective degree sequence over N symbols, runs progressive edge
growth, and writes the parity-check matrix as .alist.  A copy of
lut_ldpc_tpu/cli/peg_gen.py on the port's own modules.

    python -m lut_ldpc_torch.cli.peg_gen 500 1000 code.alist ensembles/rate0.50_dv03_dc06.ens
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="peg_gen", description=__doc__)
    ap.add_argument("M", type=int, help="number of check nodes")
    ap.add_argument("N", type=int, help="number of variable nodes")
    ap.add_argument("alist", help="output .alist file")
    ap.add_argument("ens", help="input .ens ensemble file")
    ap.add_argument("--sgl-concent", type=int, default=1,
                    help="1 = unconstrained check degrees, 0 = concentrated")
    ap.add_argument("--tgt-girth", type=int, default=100000,
                    help="target girth (large = greedy)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--girth-log", default="", help="write local girths here")
    args = ap.parse_args(argv)

    from ..core.alist import write_alist
    from ..core.ensemble import LDPCEnsemble
    from ..core.peg import peg_code_from_ensemble

    ens = LDPCEnsemble.read(args.ens)
    graph, lg = peg_code_from_ensemble(
        ens, args.M, args.N, args.sgl_concent, args.tgt_girth, args.seed
    )
    write_alist(args.alist, graph.to_dense())
    finite = lg[lg > 0]
    girth = int(finite.min()) if len(finite) else -1
    print(f"Wrote {args.alist}: N={graph.nvar} M={graph.nchk} "
          f"edges={graph.num_edges} girth={'inf' if girth < 0 else girth}")
    if args.girth_log:
        with open(args.girth_log, "w") as f:
            f.write(" ".join("inf" if x < 0 else str(x) for x in lg) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
