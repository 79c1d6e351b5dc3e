"""dump_stimuli CLI: generate VHDL-testbench stimuli from a codec artifact.

The reference captures (quantized channel input, hard output) pairs — plus
optional per-iteration message streams — by setting output_verbosity on a
BER run and awk-extracting stdout (QUICKSTART.md:33-53).  This tool
produces the same text directly: load a codec (.it or .npz), simulate
frames over BPSK/AWGN at a given SNR, and write the reference-format dump.
The frames run through the scalar golden model (``decode_ref``) on the
host.  A copy of lut_ldpc_tpu/cli/dump_stimuli.py on the port's own modules.

  python -m lut_ldpc_torch.cli.dump_stimuli codec.it --snr 3.0 --frames 4 \
      --verbosity 2 -o stimuli.txt
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dump_stimuli", description=__doc__)
    ap.add_argument("codec", help="codec artifact (.it or .npz)")
    ap.add_argument("--snr", type=float, default=3.0, help="Eb/N0 in dB")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbosity", type=int, default=1, choices=(1, 2, 3))
    ap.add_argument("-o", "--output", default="-", help="output file (- = stdout)")
    args = ap.parse_args(argv)

    from ..decoder.codec import LUTCodec
    from ..ops.pmf import snr2sig

    if args.codec.endswith(".it"):
        codec = LUTCodec.load_itfile(args.codec)
    else:
        codec = LUTCodec.load(args.codec)

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    rng = np.random.default_rng(args.seed)
    sig = float(snr2sig(codec.rate(), args.snr))
    for _ in range(args.frames):
        y = 1.0 + sig * rng.standard_normal(codec.nvar)
        llr = 2.0 * y / sig**2
        llr_cha, llr_msg = codec.quantize_channel(llr)
        codec.decode_ref(llr_cha, llr_msg, verbosity=args.verbosity, out=out)
    if out is not sys.stdout:
        out.close()
        print(f"Wrote {args.frames} stimuli frames to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
