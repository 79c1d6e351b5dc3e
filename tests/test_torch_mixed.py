"""Port decoders on unstructured (PEG) graphs against the JAX package and
the scalar golden model.

``MixedArithDecoder`` (int16 front, full float32 finish), ``HybridLUTDecoder`` with its float32 middle segment,
``ChunkedDecoder`` and ``make_staged_decoder``.  Codecs are designed once by
the JAX package and carried across with ``codec_from_arrays``; the same
labels (numpy seed) go through both packages.  The JAX side runs its Pallas
kernels in interpret mode where that is what picks the class under test
(such a decode costs over a minute of tracing, so there is one), and its
table decoder (which the JAX suite holds bit-identical to the kernels)
elsewhere.  CPU tensors take the kernels' plain twins.  Tolerance: zero
(bits, ok and iters must be identical).
"""

import os
import sys

import numpy as np
import pytest
import torch

from lut_ldpc_tpu.core.tanner import TannerGraph
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.decoder import make_staged_decoder as jax_make_staged
from lut_ldpc_tpu.decoder.fast_decoder import FastLUTDecoder as JaxFast

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_carry import carry, labels  # noqa: E402

import lut_ldpc_torch.decoder as port  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _peg(n):
    return TannerGraph.from_alist(os.path.join(
        REPO, "codes", f"rate0.50_dv02-17_dc08-09_lut_q4_N{n}.alist"))


def _design(n, sigma, iters, tmp):
    codec = LUTCodec.design(_peg(n), sigma**2, max_iters=iters,
                            Nq_Cha=16, Nq_Msg=16)
    return carry(codec, tmp / f"peg{n}_{sigma}_{iters}.npz")


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("mixed_codecs")


@pytest.fixture(scope="module")
def mixed500(tmp):
    """N=500, 12 iterations: int16 validates 10, the full f32 spec 11."""
    return _design(500, 0.80, 12, tmp)


@pytest.fixture(scope="module")
def mixed1000(tmp):
    """N=1000, 20 iterations: int16 validates 18, the full f32 spec 19."""
    return _design(1000, 0.85, 20, tmp)


@pytest.fixture(scope="module")
def hybrid500(tmp):
    """N=500, 30 iterations: int16 prefix 21, f32 prefix 29, no full spec:
    a hybrid with a float32 middle segment."""
    return _design(500, 0.85, 30, tmp)


@pytest.fixture(scope="module")
def jax_mixed500(mixed500):
    """The JAX ladder's decoder (kernels in interpret mode) and its output
    on a batch whose frames stop before, inside and after the float32
    segment."""
    jcodec, _ = mixed500
    lc, lm = labels(jcodec, 1.0, 32, 1)
    os.environ["LUT_LDPC_PALLAS_INTERPRET"] = "1"
    try:
        dec = jax_make_staged(jcodec, early_exit=True)
        out = [np.asarray(o) for o in dec(lc, lm)]
    finally:
        del os.environ["LUT_LDPC_PALLAS_INTERPRET"]
    return dec, lc, lm, out


def _same(ours, theirs):
    for x, y in zip(ours, theirs):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        np.testing.assert_array_equal(x, np.asarray(y))


def _golden(codec, lc, lm, out, frames):
    bits, ok, iters = [o.numpy() for o in out]
    for f in frames:
        b_ref, it_ref = codec.decode_ref(lc[f], lm[f])
        np.testing.assert_array_equal(np.asarray(b_ref), bits[f])
        assert abs(it_ref) == iters[f]
        assert ok[f] == (it_ref > 0)


def test_mixed_matches_jax_across_the_seam(mixed500, jax_mixed500):
    _, pcodec = mixed500
    jdec, lc, lm, want = jax_mixed500
    dec = port.MixedArithDecoder(pcodec, "cpu")
    assert type(jdec).__name__ == "MixedArithDecoder"
    assert (dec.S16, dec.S) == (jdec.S16, jdec.S) == (10, 11)
    ours = dec(lc, lm)
    _same(ours, want)
    iters = ours[2].numpy()
    assert dec.fin_runs == 1
    # frames latched in the int16 segment, at the first float32 iteration
    # (from the seam's sign data), after it, and never
    assert (iters < dec.S16).any() and (iters == dec.S16).any()
    assert (iters == dec.S).any() and (iters == pcodec.max_iters).any()
    assert ours[0].dtype == torch.uint8 and ours[2].dtype == torch.int32


def test_staged_picks_mixed_and_matches_jax(mixed500, jax_mixed500):
    _, pcodec = mixed500
    _, lc, lm, want = jax_mixed500
    dec = port.make_staged_decoder(pcodec, "cpu")
    assert isinstance(dec, port.MixedArithDecoder)
    assert dec.pre.plan is None and dec.fin.plan is None  # the std path
    _same(dec(lc, lm), want)


def test_chunked_equals_unchunked_and_jax(mixed500, jax_mixed500, monkeypatch):
    _, pcodec = mixed500
    _, lc, lm, want = jax_mixed500
    # a budget that fits 32 frames of this graph: chunks of 32 under a
    # caller who announces batches of 64
    g = pcodec.graph
    monkeypatch.setenv("LUT_DECODE_MEM_BUDGET",
                       str(40 * g.num_edges * int(g.dv_vec.max()) * 2))
    dec = port.make_staged_decoder(pcodec, "cpu", max_batch=64)
    assert isinstance(dec, port.ChunkedDecoder) and dec.chunk == 32
    assert isinstance(dec.inner, port.MixedArithDecoder)
    _same(dec(lc, lm), want)  # one chunk
    _same(port.ChunkedDecoder(dec.inner, 12)(lc, lm), want)  # 12 + 12 + 8


def test_mixed_golden(mixed500):
    jcodec, pcodec = mixed500
    lc, lm = labels(jcodec, 1.5, 12, 2)
    out = port.MixedArithDecoder(pcodec, "cpu")(lc, lm)
    _golden(pcodec, lc, lm, out, range(5))
    _golden(jcodec, lc, lm, out, [0])


def test_mixed_n1000_matches_jax_table_decoder_and_golden(mixed1000):
    jcodec, pcodec = mixed1000
    lc, lm = labels(jcodec, 1.6, 24, 3)
    dec = port.make_staged_decoder(pcodec, "cpu")
    assert isinstance(dec, port.MixedArithDecoder)
    assert (dec.S16, dec.S) == (18, 19)
    ours = dec(lc, lm)
    _same(ours, JaxFast(jcodec, early_exit=True)(lc, lm))
    iters = ours[2].numpy()
    assert (iters < dec.S16).any() and (iters > dec.S16).any()
    late = int(np.argmax(iters))
    _golden(pcodec, lc, lm, ours, [0, late])


def test_hybrid_mid_segment_matches_jax_table_decoder(hybrid500):
    jcodec, pcodec = hybrid500
    lc, lm = labels(jcodec, 1.5, 24, 4)
    dec = port.make_staged_decoder(pcodec, "cpu")
    assert isinstance(dec, port.HybridLUTDecoder) and dec.mid is not None
    assert (dec.pre.S, dec.S) == (21, 29)
    ours = dec(lc, lm)
    assert dec.mid_runs == 1 and dec.tail_runs == 1
    _same(ours, JaxFast(jcodec, early_exit=True)(lc, lm))
    iters = ours[2].numpy()
    assert ((iters > 21) & (iters <= 29)).any()  # latched in the f32 segment
    _golden(pcodec, lc, lm, ours, [int(np.argmax((iters > 21) & (iters <= 29)))])
