"""The rest of the port's decoder ladder against the JAX package and the
scalar golden model: the general ``LUTDecoder``, the table decoder with CN
LUT trees (a codec designed with ``min_lut=False``), ``StagedLUTDecoder``,
and the class each ladder function picks.

Codecs are designed by the JAX package on a (3,6) QC code with Z=16 and
carried across; labels come from a numpy seed.  Tolerance: zero (bits, ok
and iters equal on every frame).
"""

import os
import sys

import numpy as np
import pytest
import torch

from lut_ldpc_tpu.core.qc import qc_expand, qc_generate_regular
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.decoder import make_decoder as jax_make_decoder
from lut_ldpc_tpu.decoder import make_staged_decoder as jax_make_staged_decoder
from lut_ldpc_tpu.decoder.fast_decoder import FastLUTDecoder as JaxFast
from lut_ldpc_tpu.decoder.lut_decoder import LUTDecoder as JaxLUTDecoder
from lut_ldpc_tpu.decoder.staged import StagedLUTDecoder as JaxStaged

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_carry import carry, labels  # noqa: E402

from lut_ldpc_torch.decoder import (ArithLUTDecoder, FastLUTDecoder,  # noqa: E402
                                    LUTDecoder, StagedLUTDecoder, make_decoder,
                                    make_staged_decoder)

torch.set_num_threads(1)


def _design(tmp, name, sigma, iters, **kw):
    g = qc_expand(qc_generate_regular(3, 6, Z=16, nb=8, seed=1))
    codec = LUTCodec.design(g, sigma**2, max_iters=iters, Nq_Cha=16, **kw)
    return carry(codec, tmp / f"{name}.npz")


@pytest.fixture(scope="module")
def codecs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ladder")
    mixed_res = np.array([16] * 4 + [8] * 4)
    return {
        # min-LUT, 30 iterations: the int16 spec covers all of them
        "minlut": _design(tmp, "minlut", 0.85, 30, Nq_Msg=16),
        # CN LUT trees: no arithmetic form, the table decoder's own rung
        "chktree": _design(tmp, "chktree", 0.70, 8, Nq_Msg=16, min_lut=False),
        # CN LUT trees and a message resolution that changes: the last rung
        "mixedres": _design(tmp, "mixedres", 0.70, 8, Nq_Msg=mixed_res,
                            min_lut=False),
    }


def _assert_same(out, jax_out):
    for a, b, name in zip(out, jax_out, ("bits", "ok", "iters")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def _assert_golden(codec, lc, lm, out, frames):
    bits, ok, iters = (np.asarray(o) for o in out)
    for f in frames:
        want, it = codec.decode_ref(lc[f], lm[f])
        np.testing.assert_array_equal(bits[f], np.asarray(want), err_msg=f"frame {f}")
        assert iters[f] == abs(it) and ok[f] == (it > 0), f"frame {f}"


@pytest.mark.parametrize("which", ["minlut", "chktree", "mixedres"])
def test_lut_decoder_matches_jax_and_golden(codecs, which):
    jcodec, pcodec = codecs[which]
    lc, lm = labels(jcodec, 3.2 if which == "minlut" else 4.2, 16, 11)
    out = LUTDecoder(pcodec, "cpu")(lc, lm)
    assert out[0].dtype == torch.uint8 and out[2].dtype == torch.int32
    _assert_same(out, JaxLUTDecoder(jcodec, early_exit=True)(lc, lm))
    _assert_golden(pcodec, lc, lm, out, range(6 if which == "minlut" else 16))
    iters = out[2].numpy()
    assert (iters < pcodec.max_iters).any()
    # without early exit every frame runs the whole budget
    full = LUTDecoder(pcodec, "cpu", early_exit=False)(lc, lm)
    _assert_same(full, JaxLUTDecoder(jcodec, early_exit=False)(lc, lm))
    assert (full[2] == pcodec.max_iters).all()


def test_chk_tree_table_decoder_matches_jax_and_golden(codecs):
    jcodec, pcodec = codecs["chktree"]
    assert not pcodec.min_lut
    lc, lm = labels(jcodec, 3.0, 24, 12)
    dec = FastLUTDecoder(pcodec, "cpu")
    assert dec.tab.chk_progs is not None and len(dec.tab.chk_xs) == len(dec.layout.cn_blocks)
    out = dec(lc, lm)
    _assert_same(out, JaxFast(jcodec, early_exit=True)(lc, lm))
    _assert_golden(pcodec, lc, lm, out, range(24))
    iters = out[2].numpy()
    assert (iters < pcodec.max_iters).any() and (iters == pcodec.max_iters).any()


@pytest.mark.parametrize("which,want", [("minlut", "ArithLUTDecoder"),
                                        ("chktree", "FastLUTDecoder"),
                                        ("mixedres", "LUTDecoder")])
def test_ladder_picks_the_jax_class(codecs, which, want, monkeypatch):
    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    jcodec, pcodec = codecs[which]
    for early_exit in (True, False):
        dec = make_decoder(pcodec, "cpu", early_exit=early_exit)
        jd = jax_make_decoder(jcodec, early_exit=early_exit)
        assert type(dec).__name__ == type(jd).__name__ == want
    dec = make_staged_decoder(pcodec, "cpu")
    jd = jax_make_staged_decoder(jcodec)
    assert type(dec).__name__ == type(jd).__name__ == want
    lc, lm = labels(jcodec, 4.0, 8, 13)
    out = dec(lc, lm)
    _assert_same(out, jd(lc, lm))
    _assert_golden(pcodec, lc, lm, out, range(4))


def test_staged_is_picked_where_the_batch_does_not_fit(codecs, monkeypatch):
    """A memory budget below 32 frames sends an arithmetic codec to
    ``StagedLUTDecoder`` in both packages (staged.py:272-284)."""
    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("LUT_DECODE_MEM_BUDGET", "50000")
    jcodec, pcodec = codecs["minlut"]
    dec = make_staged_decoder(pcodec, "cpu")
    jd = jax_make_staged_decoder(jcodec)
    assert isinstance(dec, StagedLUTDecoder) and isinstance(jd, JaxStaged)
    assert dec.stage_iters == jd.stage_iters and dec._dtype == jd._dtype
    assert type(dec.full).__name__ == type(jd.full).__name__ == "ArithLUTDecoder"
    assert (dec._max_pad, dec._max_pad_full) == (jd._max_pad, jd._max_pad_full)


def test_staged_decoder_matches_jax_and_golden(codecs, monkeypatch):
    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    jcodec, pcodec = codecs["minlut"]
    lc, lm = labels(jcodec, 1.6, 48, 14)
    dec = StagedLUTDecoder(pcodec, "cpu", adapt=False)
    jd = JaxStaged(jcodec, adapt=False)
    assert dec.stage_iters == jd.stage_iters == [8, 29]
    assert all(isinstance(s, ArithLUTDecoder) and s.is_prefix for s in dec.stages)
    out = dec(lc, lm)
    _assert_same(out, jd(lc, lm))
    iters = out[2].numpy()
    # frames that finish in the first stage, in the second, and in the full
    # decoder (or never)
    first = np.nonzero(iters <= 8)[0]
    second = np.nonzero((iters > 8) & (iters <= 29))[0]
    last = np.nonzero(iters > 29)[0]
    assert first.size and second.size and last.size
    _assert_golden(pcodec, lc, lm, out,
                   list(first[:2]) + list(second[:2]) + list(last[:2]))
    # equal to the unstaged decoder on every frame
    _assert_same(out, make_decoder(pcodec, "cpu")(lc, lm))


def test_staged_adapts_its_plan_like_jax(codecs, monkeypatch):
    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    jcodec, pcodec = codecs["minlut"]
    lc, lm = labels(jcodec, 2.6, 96, 15)
    dec, jd = StagedLUTDecoder(pcodec, "cpu"), JaxStaged(jcodec)
    _assert_same(dec(lc, lm), jd(lc, lm))
    assert dec.stage_iters == jd.stage_iters != [8, 29]
    _assert_same(dec(lc, lm), jd(lc, lm))  # the second call runs the new plan
    with pytest.raises(ValueError):
        StagedLUTDecoder(pcodec, "cpu", early_exit=False)
