"""The value-domain loop's glue (``lut_ldpc_torch.decoder.loop_glue``)
against what it replaced and against the JAX package.

The plain versions of the loop-state, latch and init kernels are held
against the torch sequences the loop ran before them (the ``where`` latch,
the int64 label chain), in every loop (QC, std, per-degree block); the
loop with its funnel
narrowed to 64 -> 16 -> 4 frames, through ``ArithLUTDecoder``,
``HybridLUTDecoder``, ``MixedArithDecoder`` (the float32 ``resume`` after
the int16 prefix) and a phantom-completed QC codec, against the JAX
package.  Codecs are designed by the JAX package and carried across; labels
come from a numpy seed.  CPU tensors take the plain versions.  Tolerance:
zero (every compared array equal).
"""

import copy
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from lut_ldpc_tpu.core import dvbs2 as jax_dvbs2
from lut_ldpc_tpu.core.qc import qc_expand, qc_generate_regular
from lut_ldpc_tpu.core.tanner import TannerGraph
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.decoder.arith import build_arith_prefix_spec
from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder as JaxArith
from lut_ldpc_tpu.decoder.fast_decoder import FastLUTDecoder as JaxFast
from lut_ldpc_tpu.decoder.hybrid import HybridLUTDecoder as JaxHybrid
from lut_ldpc_tpu.decoder.lut_decoder import LUTDecoder as JaxLUTDecoder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_carry import carry, labels  # noqa: E402

import lut_ldpc_torch.decoder as port  # noqa: E402
from lut_ldpc_torch.decoder import loop_glue as lg  # noqa: E402
from lut_ldpc_torch.decoder.arith_decoder import as_labels, funnel_widths  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"int16": np.int16, "float32": np.float32}


@pytest.fixture(scope="module")
def degenerate(tmp_path_factory):
    """(JAX codec, port codec) of a (3,6) QC code, Z=40: the int16 prefix
    covers 32 of 40 iterations."""
    qc = qc_generate_regular(3, 6, Z=40, nb=12, seed=3)
    codec = LUTCodec.design(qc_expand(qc), 0.85**2, max_iters=40, Nq_Cha=16, Nq_Msg=16)
    return codec, carry(codec, tmp_path_factory.mktemp("g") / "deg.npz")[1]


@pytest.fixture(scope="module")
def mixed500(tmp_path_factory):
    """(JAX reload, port codec) of the N=500 PEG code, 12 iterations: int16
    validates 10, the full float32 spec 11."""
    g = TannerGraph.from_alist(os.path.join(REPO, "codes",
                                            "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist"))
    codec = LUTCodec.design(g, 0.80**2, max_iters=12, Nq_Cha=16, Nq_Msg=16)
    return carry(codec, tmp_path_factory.mktemp("g") / "peg500.npz")


@pytest.fixture(scope="module")
def analog(tmp_path_factory):
    """(JAX reload, port codec) of the toy DVB-S2 analog of
    tests/test_torch_phantom.py: Z=16, one phantom completion of true
    degree 1."""
    z, q = 16, 4
    m = z * q
    groups = [[0, 9, 34], [3, 21, 46], [1, 6, 11, 36], [2, 7, 23, 16]]
    n = len(groups) * z + m
    cols = [np.array(sorted((x + t * q) % m for x in g)) for g in groups for t in range(z)]
    cols += [np.array([j] if j == m - 1 else [j, j + 1]) for j in range(m)]
    st = jax_dvbs2.periodic_qc_structure(cols, n, m, z)[0]
    codec = LUTCodec.design(qc_expand(st), 0.9**2, max_iters=10, Nq_Cha=16, Nq_Msg=16)
    return carry(codec, tmp_path_factory.mktemp("g") / "analog.npz")


def _without_qc(codec):
    g = copy.copy(codec.graph)
    del g.qc
    return dataclasses.replace(codec, graph=g)


def _decoder(pcodec, dtype, loop):
    """A prefix-spec ArithLUTDecoder of `pcodec` on the QC, std or block loop."""
    codec = _without_qc(pcodec) if loop == "std" else pcodec
    spec = port.build_arith_prefix_spec(codec, dtype=DTYPES[dtype])
    dec = port.ArithLUTDecoder(codec, "cpu", spec=spec,
                               loop="blocks" if loop == "blocks" else "auto")
    assert dec.loop == loop
    return dec


def _real(dec, a):
    return a.numpy()[dec.tables.node_real.numpy()]


# ---------------------------------------------------------------------------
# the loop-state and latch plain versions against the where sequence
# ---------------------------------------------------------------------------
def _old_step(dec, vcha, state, it):
    """One iteration as the loop ran it before the glue kernels."""
    m_vn, bits_p, unan_p, done, latched, iters = state
    m_cn, synd = dec._cn(m_vn)
    conv = unan_p & synd & ~done
    if it < 1:
        conv = torch.zeros_like(conv)
    latched = torch.where(conv[None, :], bits_p, latched)
    iters = torch.where(conv, torch.full_like(iters, it), iters)
    done = done | conv
    m_vn, bits_p, unan_p = dec._vn(m_cn, vcha, it)
    return [m_vn, bits_p, unan_p, done, latched, iters], conv


def _new_step(dec, vcha, state, it, live):
    m_vn, bits_p, unan_p, done, latched, iters = state
    m_cn, synd = dec._cn(m_vn)
    conv = lg.loop_state(unan_p, synd, done, iters, it, live)
    lg.latch(conv, bits_p, latched)
    m_vn, bits_p, unan_p = dec._vn(m_cn, vcha, it)
    return [m_vn, bits_p, unan_p, done, latched, iters], conv


@pytest.mark.parametrize("B", [64, 61])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("it", [0, 1, 5])
def test_loop_state_and_latch_match_the_where_sequence(degenerate, it, dtype, B):
    rng = np.random.default_rng(100 * it + B)
    # on random flags: loop_state's plain version, then latch's
    f = lambda: torch.as_tensor(rng.integers(0, 2, B).astype(bool))
    unan, synd, done = f(), f(), f()
    iters = torch.as_tensor(rng.integers(0, 40, B).astype(np.int32))
    prev = torch.as_tensor(rng.integers(0, 2, (30, B)).astype(np.int8))
    lat = torch.as_tensor(rng.integers(0, 2, (30, B)).astype(np.int8))
    want_conv = unan & synd & ~done if it >= 1 else torch.zeros_like(done)
    want = (torch.where(want_conv[None, :], prev, lat),
            torch.where(want_conv, torch.full_like(iters, it), iters), done | want_conv)
    live = lg.LiveCount(torch.device("cpu"))
    conv = lg.loop_state(unan, synd, done, iters, it, live)
    lg.latch(conv, prev, lat)
    assert torch.equal(conv, want_conv)
    for got, exp in zip((lat, iters, done), want):
        assert torch.equal(got, exp)
    assert live.read() == int((~want[2]).sum())
    # on a decode: every iteration up to `it` both ways, on each loop
    for loop in ("qc", "std", "blocks"):
        _steps_both_ways(_decoder(degenerate[1], dtype, loop), degenerate[0], it, B)


def _steps_both_ways(dec, codec, it, B):
    """Iterations 0..it of `dec` through the where sequence and through the
    glue's plain versions: equal state after each."""
    lc, lm = labels(codec, 2.5, B, it + 7)
    vcha, old = dec._init(lc, lm)
    _, new = dec._init(lc, lm)
    live = lg.LiveCount(torch.device("cpu"))
    for k in range(it + 1):
        old, c_old = _old_step(dec, vcha, old, k)
        new, c_new = _new_step(dec, vcha, new, k, live)
        assert torch.equal(c_old, c_new)
        for a, b in zip(old[1:], new[1:]):
            assert torch.equal(a, b)
        assert live.read() == int((~old[3]).sum())
    if it == 5:
        assert bool(old[3].any()) and not bool(old[3].all())


def test_loop_state_and_latch_check_their_arguments():
    flags = torch.zeros(8, dtype=torch.bool)
    iters = torch.zeros(8, dtype=torch.int32)
    bits = torch.zeros((5, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        lg.loop_state(flags, flags, flags, iters.long(), 1)
    with pytest.raises(ValueError):
        lg.loop_state(flags[:7], flags, flags, iters, 1)
    with pytest.raises(TypeError):
        lg.latch(flags, bits, bits.to(torch.uint8))
    with pytest.raises(ValueError):
        lg.latch(flags, bits, bits[:4])


# ---------------------------------------------------------------------------
# the loop and its funnel against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture
def narrow_funnel(monkeypatch):
    """LUT_FUNNEL_MIN=4 (64 -> 16 -> 4 frames), and the live counts every
    loop reads."""
    monkeypatch.setenv("LUT_FUNNEL_MIN", "4")
    assert funnel_widths(64) == [64, 16, 4]
    seen = []
    read = lg.LiveCount.read
    monkeypatch.setattr(lg.LiveCount, "read",
                        lambda self: seen.append(read(self)) or seen[-1])
    return seen


def _same(ours, theirs):
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_funnel_and_raw_carry_match_jax(degenerate, narrow_funnel):
    codec, pcodec = degenerate
    spec = build_arith_prefix_spec(codec, dtype=np.int16)
    dec = _decoder(pcodec, "int16", "qc")
    lc, lm = labels(codec, 2.5, 64, 31)
    m, done, latched, iters = dec.raw_carry(lc, lm)
    # both shrinks taken before the prefix's end: 16 and then 4 live frames
    assert min(narrow_funnel[:-1]) <= 4
    jm, jdone, jlat, jiters = JaxArith(codec, early_exit=True, spec=spec)._raw_carry_fn()(
        np.asarray(lc, np.int32), np.asarray(lm, np.int32))
    real = dec.tables.vn_real.numpy()
    np.testing.assert_array_equal(m.numpy()[real], np.asarray(jm)[real])
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(_real(dec, latched), np.asarray(jlat)[dec.tables.node_real])
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    assert not done.all() and latched.dtype == torch.uint8
    assert not latched.numpy()[:, ~done.numpy()].any()
    _same(dec(lc, lm), JaxArith(codec, early_exit=True, spec=spec)(lc, lm))


@pytest.mark.parametrize("seed, tail", [(21, 0), (31, 1)])
def test_funnel_through_the_hybrid_matches_jax(degenerate, narrow_funnel, seed, tail):
    codec, pcodec = degenerate
    lc, lm = labels(codec, 2.5, 64, seed)
    dec = port.HybridLUTDecoder(pcodec, "cpu")
    _same(dec(lc, lm), JaxHybrid(codec)(lc, lm))
    assert min(narrow_funnel) <= 4 and dec.tail_runs == tail


def test_funnel_through_the_mixed_decoder_matches_jax(mixed500, narrow_funnel):
    jcodec, pcodec = mixed500
    lc, lm = labels(jcodec, 1.0, 64, 1)
    dec = port.MixedArithDecoder(pcodec, "cpu")
    ours = dec(lc, lm)
    assert dec.fin_runs == 1
    _same(ours, JaxFast(jcodec, early_exit=True)(lc, lm))
    iters = ours[2].numpy()
    assert (iters < dec.S16).any() and (iters == dec.S).any()


def test_resume_leaves_the_callers_tensors_alone(mixed500, narrow_funnel):
    """The float32 segment updates done, iters and latched in place: on its
    own copies where the caller's tensors would be its own (an int8
    latched is one), as a funnel merge before any step would."""
    jcodec, pcodec = mixed500
    lc, lm = labels(jcodec, 1.0, 64, 1)
    dec = port.MixedArithDecoder(pcodec, "cpu")
    m16, done, latched, iters = dec.pre.raw_carry(lc, lm)
    from lut_ldpc_torch.decoder.hybrid import seam_bits_unan, seam_values

    v32 = seam_values(m16, dec._seam16, dec._seam32)
    bits_p, unan_p = seam_bits_unan(dec.fin.layout, v32)
    given = [t.clone() for t in (v32, bits_p, unan_p, done, latched, iters)]
    lat8 = latched.to(torch.int8)
    out = dec.fin.resume(dec.S16, lc, v32, bits_p, unan_p, done, lat8, iters)
    for t, g in zip((v32, bits_p, unan_p, done, lat8.to(torch.uint8), iters), given):
        assert torch.equal(t, g)
    _same(out, JaxFast(jcodec, early_exit=True)(lc, lm))
    # every frame already done: the shrinks come before the first step
    done_all = torch.ones_like(done)
    out = dec.fin.resume(dec.S16, lc, v32, bits_p, unan_p, done_all, lat8, iters, raw=True)
    assert torch.equal(done_all, torch.ones_like(done)) and torch.equal(v32, given[0])
    assert torch.equal(out[1], done_all) and torch.equal(out[3], iters)


def test_funnel_on_a_phantom_codec_matches_jax(analog, narrow_funnel):
    jcodec, pcodec = analog
    lc, lm = labels(jcodec, 9.0, 64, 8)  # a toy code: its floor keeps 2 frames live
    dec = port.make_decoder(pcodec, "cpu")
    assert isinstance(dec, port.ArithLUTDecoder) and dec.loop == "qc" and dec._ph
    ours = dec(lc, lm)
    _same(ours, JaxLUTDecoder(jcodec, early_exit=True)(lc, lm))
    assert min(narrow_funnel) <= 4
    iters = ours[2].numpy()
    assert (iters < pcodec.max_iters).any() and (iters == pcodec.max_iters).any()


# ---------------------------------------------------------------------------
# the initial values
# ---------------------------------------------------------------------------
def _old_init(dec, lc, lm):
    """The int64 chain the decoder ran before the init kernel."""
    cha, msg = torch.as_tensor(lc).long(), torch.as_tensor(lm).long()
    ten = dec.ten
    vcha = ten.leaf_cha[cha[:, ten.vn_nodes].T].contiguous()
    m_vn = ten.leaf_msg0[msg[:, ten.vn_nodes].T][ten.edge_node].contiguous()
    if dec._ph:
        m_vn[dec._rows_ph] = dec._pin
    return vcha, m_vn


@pytest.mark.parametrize("label", ["int32", "int64"])
@pytest.mark.parametrize("case", ["qc-int16", "qc-float32", "std-int16", "blocks-float32",
                                  "phantom-int16", "phantom-float32"])
def test_init_values_match_the_old_chain(degenerate, analog, case, label):
    loop, dtype = case.split("-")
    if loop == "phantom":
        jcodec, pcodec = analog
        dec = port.ArithLUTDecoder(
            pcodec, "cpu", spec=port.build_arith_spec(pcodec, dtype=DTYPES[dtype]))
        assert dec._ph and dec.loop == "qc"
    else:
        jcodec, pcodec = degenerate
        dec = _decoder(pcodec, dtype, loop)
    lc, lm = (a.astype(label) for a in labels(jcodec, 1.5, 37, 2))
    want = _old_init(dec, lc, lm)
    cha, msg = torch.as_tensor(lc), torch.as_tensor(lm)
    assert as_labels(cha, dec.device, dec.nvar) is cha  # no int64 copy
    got = lg.init_values(cha, msg, dec._init_tab, dec.ten.leaf_cha, dec.ten.leaf_msg0,
                         dec._pin, dec.layout.num_edges_vn)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    vcha, none = lg.init_values_ref(cha, None, dec._init_tab, dec.ten.leaf_cha,
                                    dec.ten.leaf_msg0, dec._pin, dec.layout.num_edges_vn)
    assert none is None and torch.equal(vcha, want[0])
    vcha, state = dec._init(lc, lm)
    assert torch.equal(vcha, want[0]) and torch.equal(state[0], want[1])


def test_init_values_checks_its_labels(degenerate):
    dec = _decoder(degenerate[1], "int16", "qc")
    lc, lm = labels(degenerate[0], 1.5, 4, 2)
    args = (dec._init_tab, dec.ten.leaf_cha, dec.ten.leaf_msg0, dec._pin,
            dec.layout.num_edges_vn)
    with pytest.raises(TypeError):
        lg.init_values(torch.as_tensor(lc).to(torch.int16), torch.as_tensor(lm), *args)
    with pytest.raises(ValueError):
        lg.init_values(torch.as_tensor(lc)[:, :-1], torch.as_tensor(lm)[:, :-1], *args)
    with pytest.raises(ValueError):
        lg.init_values(torch.as_tensor(lc), torch.as_tensor(lm)[:2], *args)
    assert as_labels(torch.as_tensor(lc).to(torch.int16), dec.device, dec.nvar).dtype \
        == torch.int64
