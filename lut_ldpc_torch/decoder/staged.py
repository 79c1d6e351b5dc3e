"""``make_staged_decoder``: the early-exit decoder a caller should use.

Keeps the JAX package's choice (lut_ldpc_tpu/decoder/staged.py:244-287):
the ``make_decoder`` result when it is a full arithmetic, mixed or hybrid
decoder whose whole batch fits the memory budget, the same decoder behind
a ``ChunkedDecoder`` when only a part of the batch fits.  Where the JAX
package would stage the batch on the host (``StagedLUTDecoder``) this
package raises NotImplementedError (ROADMAP A9).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .arith import ArithBuildError, build_arith_prefix_spec
from .arith_decoder import ArithLUTDecoder
from .fast_decoder import make_decoder
from .hybrid import HybridLUTDecoder, MixedArithDecoder

__all__ = ["ChunkedDecoder", "make_staged_decoder"]


class ChunkedDecoder:
    """Split oversized batches into budget-sized chunks and run the inner
    decoder per chunk (staged.py:214).  Frames are independent and the
    inner decoder is deterministic, so outputs are bit-identical to one
    full-batch call.  The short final chunk runs at its own width: eager
    kernels take any batch width, so it needs none of the JAX package's
    padding to a compiled shape."""

    def __init__(self, inner, chunk: int):
        if chunk < 1:
            raise ValueError("chunk must be positive")
        self.inner = inner
        self.chunk = int(chunk)

    def __call__(self, llr_cha, llr_msg):
        B = llr_cha.shape[0]
        if B <= self.chunk:
            return self.inner(llr_cha, llr_msg)
        outs = [self.inner(llr_cha[lo : lo + self.chunk],
                           llr_msg[lo : lo + self.chunk])
                for lo in range(0, B, self.chunk)]
        return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


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
    if full_arith or isinstance(dec, (HybridLUTDecoder, MixedArithDecoder)):
        if fit >= max_batch:
            return dec
        if fit >= 32:
            chunk = 32
            while chunk * 2 <= fit:
                chunk *= 2
            return ChunkedDecoder(dec, chunk)
    if _staged_builds(codec):
        raise NotImplementedError("StagedLUTDecoder: ROADMAP A9")
    return dec
