from .._ref import LUTCodec
from .arith_decoder import ArithLUTDecoder
from .fast_decoder import FastLUTDecoder, make_decoder
from .hybrid import HybridLUTDecoder
from .lut_decoder import cn_minsum
from .staged import make_staged_decoder

__all__ = [
    "ArithLUTDecoder",
    "FastLUTDecoder",
    "HybridLUTDecoder",
    "LUTCodec",
    "cn_minsum",
    "make_decoder",
    "make_staged_decoder",
]
