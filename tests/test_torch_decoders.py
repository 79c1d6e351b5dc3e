"""Port decoders against the JAX decoders and the scalar golden model.

Same labels (numpy seed) through both packages; bits, ok and iters must be
identical (tolerance zero).  The degenerate fixture's arithmetic spec
covers 32 of 40 iterations, so the hybrid's table tail runs never (4 dB),
for some frames (1.5, 2.5 dB) or for all frames (0 dB).  CPU tensors take
the kernels' plain twins.
"""

import numpy as np
import pytest
import torch

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble
from lut_ldpc_tpu.core.qc import qc_expand, qc_generate_irregular, qc_generate_regular
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.decoder import make_staged_decoder as jax_make_staged
from lut_ldpc_tpu.decoder.arith import build_arith_prefix_spec, build_arith_spec
from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder as JaxArith
from lut_ldpc_tpu.decoder.fast_decoder import FastLUTDecoder as JaxFast
from lut_ldpc_tpu.decoder.hybrid import HybridLUTDecoder as JaxHybrid
from lut_ldpc_tpu.ops.pmf import snr2sig

import lut_ldpc_torch.decoder as port
from lut_ldpc_torch import _ref
from lut_ldpc_torch.decoder import qc_kernels as qk

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def codec_degenerate():
    qc = qc_generate_regular(3, 6, Z=40, nb=12, seed=3)
    return LUTCodec.design(qc_expand(qc), 0.85**2, max_iters=40,
                           Nq_Cha=16, Nq_Msg=16)


@pytest.fixture(scope="module")
def codec_irr():
    e = LDPCEnsemble.read("ensembles/rate0.50_dv02-17_dc08-09_lut_q4.ens")
    return LUTCodec.design(qc_expand(qc_generate_irregular(e, Z=24, nb=60, seed=1)),
                           0.90**2, max_iters=10, Nq_Cha=16, Nq_Msg=16)


@pytest.fixture(scope="module")
def port_hybrid(codec_degenerate):
    return port.HybridLUTDecoder(codec_degenerate, "cpu")


def _labels(codec, snr, B, seed):
    rng = np.random.default_rng(seed)
    sig = float(snr2sig(0.5, snr))
    y = 1.0 + sig * rng.standard_normal((B, codec.nvar))
    return codec.quantize_channel(2.0 * y / sig**2)


def _same(a, b):
    for x, y in zip(a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        np.testing.assert_array_equal(x, y)


def _golden(codec, lc, lm, out, frames):
    bits, _, iters = [o.numpy() for o in out]
    for f in frames:
        b_ref, it_ref = codec.decode_ref(np.asarray(lc)[f], np.asarray(lm)[f])
        np.testing.assert_array_equal(np.asarray(b_ref), bits[f])
        assert (it_ref if it_ref > 0 else codec.max_iters) == iters[f]


def test_staged_picks_same_class(codec_degenerate, codec_irr):
    for codec in (codec_degenerate, codec_irr):
        ours = port.make_staged_decoder(codec, "cpu")
        theirs = jax_make_staged(codec, early_exit=True)
        assert type(ours).__name__ == type(theirs).__name__
    assert isinstance(port.make_staged_decoder(codec_degenerate, "cpu"),
                      port.HybridLUTDecoder)


@pytest.mark.parametrize("snr", [0.0, 1.5, 2.5, 4.0])
def test_hybrid_matches_jax(codec_degenerate, port_hybrid, snr):
    codec = codec_degenerate
    lc, lm = _labels(codec, snr, 64, int(snr * 10) + 1)
    runs = port_hybrid.tail_runs
    ours = port_hybrid(lc, lm)
    _same(ours, JaxHybrid(codec)(lc, lm))
    all_done = bool((ours[2] < port_hybrid.S).all())
    assert port_hybrid.tail_runs == runs + (0 if all_done else 1)
    if snr == 0.0:
        assert port_hybrid.tail_runs == runs + 1
    if snr == 4.0:
        assert all_done


def test_hybrid_golden(codec_degenerate, port_hybrid):
    codec = codec_degenerate
    lc, lm = _labels(codec, 1.5, 16, 7)
    out = port_hybrid(lc, lm)
    _golden(codec, lc, lm, out, range(6))


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_full_arith_matches_jax_and_golden(codec_irr, dtype):
    spec = build_arith_spec(codec_irr, dtype=dtype)
    lc, lm = _labels(codec_irr, 2.0, 48, 5)
    ours = port.ArithLUTDecoder(codec_irr, "cpu", spec=spec)(lc, lm)
    _same(ours, JaxArith(codec_irr, early_exit=True, spec=spec)(lc, lm))
    _golden(codec_irr, lc, lm, ours, range(3))


def test_full_arith_without_early_exit_matches_jax(codec_irr):
    spec = build_arith_spec(codec_irr, dtype=np.int16)
    lc, lm = _labels(codec_irr, 1.8, 16, 10)
    ours = port.ArithLUTDecoder(codec_irr, "cpu", early_exit=False, spec=spec)(lc, lm)
    _same(ours, JaxArith(codec_irr, early_exit=False, spec=spec)(lc, lm))
    assert (ours[2] == codec_irr.max_iters).all()


def test_prefix_and_funnel_match_jax(codec_degenerate, monkeypatch):
    """Prefix mode, with a funnel narrowed to 64 -> 16 -> 4 frames."""
    monkeypatch.setenv("LUT_FUNNEL_MIN", "4")
    codec = codec_degenerate
    spec = build_arith_prefix_spec(codec, dtype=np.int16)
    assert port.arith_decoder.funnel_widths(64) == [64, 16, 4]
    lc, lm = _labels(codec, 2.5, 64, 3)
    ours = port.ArithLUTDecoder(codec, "cpu", spec=spec)(lc, lm)
    _same(ours, JaxArith(codec, early_exit=True, spec=spec)(lc, lm))


def test_raw_carry_matches_jax(codec_degenerate):
    codec = codec_degenerate
    spec = build_arith_prefix_spec(codec, dtype=np.int16)
    lc, lm = _labels(codec, 1.5, 32, 4)
    dec = port.ArithLUTDecoder(codec, "cpu", spec=spec)
    m, done, latched, iters = dec.raw_carry(lc, lm)
    jm, jdone, jlat, jiters = JaxArith(codec, early_exit=True,
                                       spec=spec)._raw_carry_fn()(
        np.asarray(lc, np.int32), np.asarray(lm, np.int32))
    real = dec.tables.vn_real.numpy()
    nodes = dec.tables.node_real.numpy()
    np.testing.assert_array_equal(m.numpy()[real], np.asarray(jm)[real])
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(latched.numpy()[nodes], np.asarray(jlat)[nodes])
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    assert not done.all()  # the carry handed to the tail is live


def test_fast_decoder_matches_jax(codec_degenerate):
    codec = codec_degenerate
    lc, lm = _labels(codec, 1.5, 32, 9)
    _same(port.FastLUTDecoder(codec, "cpu")(lc, lm),
          JaxFast(codec, early_exit=True)(lc, lm))


def test_cn_minsum_matches_jax():
    from lut_ldpc_tpu.decoder.lut_decoder import cn_minsum as jax_cn_minsum

    m = np.random.default_rng(2).integers(0, 16, size=(5, 7, 6)).astype(np.int8)
    np.testing.assert_array_equal(port.cn_minsum(torch.as_tensor(m), 8).numpy(),
                                  np.asarray(jax_cn_minsum(m, 8)))


def test_saved_codec_decodes_identically(codec_degenerate, port_hybrid, tmp_path):
    path = str(tmp_path / "codec.npz")
    codec_degenerate.save(path)
    loaded = _ref.LUTCodec.load(path)
    assert _ref.LUTCodec is LUTCodec
    lc, lm = _labels(codec_degenerate, 1.5, 32, 8)
    _same(port.make_staged_decoder(loaded, "cpu")(lc, lm), port_hybrid(lc, lm))


def test_twin_switch_and_input_checks(codec_degenerate):
    codec = codec_degenerate
    spec = build_arith_prefix_spec(codec, dtype=np.float32)
    lc, lm = _labels(codec, 2.5, 16, 6)
    qk.reset_launches()
    a = port.ArithLUTDecoder(codec, "cpu", spec=spec)(lc, lm)
    b = port.ArithLUTDecoder(codec, "cpu", spec=spec, kernels=False)(lc, lm)
    _same(a, b)
    assert qk.LAUNCHES == {"cn_qc_pass": 0, "vn_qc_pass": 0}
    dec = port.ArithLUTDecoder(codec, "cpu", spec=spec)
    with pytest.raises(ValueError):
        dec(lc[:, :-1], lm[:, :-1])
    with pytest.raises(TypeError):
        dec(lc.astype(np.float32), lm)
    with pytest.raises(ValueError):
        port.ArithLUTDecoder(codec, None, spec=spec)
