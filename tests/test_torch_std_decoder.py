"""The std branch of the port's ``ArithLUTDecoder`` (graphs without a
quasi-cyclic plan) against the JAX package and the scalar golden model, on
the N=500 PEG code with a full spec.  The codec is designed by the JAX
package and carried across with ``codec_from_arrays``; the same labels
(numpy seed) go through both.  CPU tensors take the kernels' plain twins.
Tolerance: zero (bits, ok and iters must be identical).
"""

import os
import sys

import numpy as np
import pytest
import torch

from lut_ldpc_tpu.core.tanner import TannerGraph
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.decoder.arith import build_arith_spec as jax_full_spec
from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder as JaxArith

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_carry import carry, labels  # noqa: E402

import lut_ldpc_torch.decoder as port  # noqa: E402
from lut_ldpc_torch.decoder import qc_kernels as qk  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def full500(tmp_path_factory):
    """N=500, 8 iterations: the full int16 spec validates."""
    g = TannerGraph.from_alist(os.path.join(
        REPO, "codes", "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist"))
    codec = LUTCodec.design(g, 0.90**2, max_iters=8, Nq_Cha=16, Nq_Msg=16)
    return carry(codec, tmp_path_factory.mktemp("std_dec") / "peg500.npz")


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


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_std_arith_matches_jax_and_golden(full500, dtype, monkeypatch):
    """Full spec on the std branch.  The JAX side runs its std kernels in
    interpret mode for int16, and its plain XLA path for float32."""
    jcodec, pcodec = full500
    if dtype == np.int16:
        monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    lc, lm = labels(jcodec, 2.0, 16, 5)
    dec = port.ArithLUTDecoder(pcodec, "cpu",
                               spec=port.build_arith_spec(pcodec, dtype=dtype))
    assert dec.plan is None and not dec.is_prefix
    ours = dec(lc, lm)
    jd = JaxArith(jcodec, early_exit=True, spec=jax_full_spec(jcodec, dtype=dtype))
    assert (jd._build_std_kernels() is not None) == (dtype == np.int16)
    _same(ours, jd(lc, lm))
    _golden(pcodec, lc, lm, ours, range(3))
    if dtype == np.int16:
        assert type(port.make_staged_decoder(pcodec, "cpu")) is port.ArithLUTDecoder


def test_resume_from_zero_equals_call_and_twin_switch(full500):
    """The continuation mode started at iteration 0 from the initial state
    is the plain decode; kernels=False is the same path on the CPU."""
    _, pcodec = full500
    lc, lm = labels(pcodec, 2.0, 8, 6)
    spec = port.build_arith_spec(pcodec, dtype=np.float32)
    dec = port.ArithLUTDecoder(pcodec, "cpu", spec=spec)
    want = dec(lc, lm)
    _, state = dec._init(lc, lm)
    _same(dec.resume(0, lc, *state), want)
    qk.reset_launches()
    _same(port.ArithLUTDecoder(pcodec, "cpu", spec=spec, kernels=False)(lc, lm), want)
    assert all(v == 0 for v in qk.LAUNCHES.values())
    with pytest.raises(ValueError):
        dec.resume(spec.num_iters + 1, lc, *state)
