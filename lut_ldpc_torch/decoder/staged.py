"""``make_staged_decoder``: the early-exit decoder a caller should use.

Keeps the JAX package's choice (lut_ldpc_tpu/decoder/staged.py:244-287):
the ``make_decoder`` result when it is a full arithmetic or hybrid decoder
whose whole batch fits the memory budget; otherwise the JAX package
chunks the batch (``ChunkedDecoder``) or stages it on the host
(``StagedLUTDecoder``), which this package does not have yet
(NotImplementedError, ROADMAP A9).
"""

from __future__ import annotations

import os

import numpy as np

from .._ref import ArithBuildError, build_arith_prefix_spec
from .arith_decoder import ArithLUTDecoder
from .fast_decoder import make_decoder
from .hybrid import HybridLUTDecoder

__all__ = ["make_staged_decoder"]


def _staged_builds(codec) -> bool:
    """Whether the JAX StagedLUTDecoder constructor succeeds: it needs an
    int16 prefix of min(8, T-1) iterations or, failing that, an f32
    prefix."""
    try:
        spec = build_arith_prefix_spec(codec, dtype=np.int16)
        if spec.num_iters >= min(8, codec.max_iters - 1):
            return True
    except ArithBuildError:
        pass
    try:
        build_arith_prefix_spec(codec, dtype=np.float32)
    except ArithBuildError:
        return False
    return True


def make_staged_decoder(codec, device, early_exit: bool = True,
                        max_batch: int = 4096):
    """Best early-exit decoder for the codec.  max_batch: the largest
    per-call batch the caller will use; LUT_DECODE_MEM_BUDGET (bytes)
    overrides the memory budget the JAX package chunks by."""
    if not early_exit:
        return make_decoder(codec, device, early_exit=False)
    dec = make_decoder(codec, device, early_exit=True)
    g = codec.graph
    budget = int(os.environ.get("LUT_DECODE_MEM_BUDGET", 1 << 30))
    fit = budget // (g.num_edges * int(g.dv_vec.max()) * 2)
    full_arith = isinstance(dec, ArithLUTDecoder) and not dec.is_prefix
    if full_arith or isinstance(dec, HybridLUTDecoder):
        if fit >= max_batch:
            return dec
        if fit >= 32:
            raise NotImplementedError(
                f"ChunkedDecoder (budget fits {fit} < {max_batch} frames): "
                "ROADMAP A9")
    if _staged_builds(codec):
        raise NotImplementedError("StagedLUTDecoder: ROADMAP A9")
    return dec
