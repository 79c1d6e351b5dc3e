from .arith import ArithBuildError, build_arith_prefix_spec, build_arith_spec
from .arith_decoder import ArithLUTDecoder
from .bp import BPDecoder, make_bp_decoder
from .codec import LUTCodec, codec_from_arrays
from .fast_decoder import FastLUTDecoder, make_decoder
from .hybrid import HybridLUTDecoder, MixedArithDecoder
from .lut_decoder import LUTDecoder, cn_minsum
from .staged import ChunkedDecoder, StagedLUTDecoder, make_staged_decoder

__all__ = [
    "ArithBuildError",
    "ArithLUTDecoder",
    "BPDecoder",
    "ChunkedDecoder",
    "FastLUTDecoder",
    "HybridLUTDecoder",
    "LUTCodec",
    "LUTDecoder",
    "MixedArithDecoder",
    "StagedLUTDecoder",
    "build_arith_prefix_spec",
    "build_arith_spec",
    "cn_minsum",
    "codec_from_arrays",
    "make_bp_decoder",
    "make_decoder",
    "make_staged_decoder",
]
