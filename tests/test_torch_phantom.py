"""Phantom-completed graphs in the port against the JAX package and the
scalar golden model.

The toy analog of the DVB-S2 construction (tests/test_dvbs2_qc.py: Z=16,
info column groups with one weight-2 cell, an accumulator staircase whose
wrap misses one edge, so the Z-periodic form has one phantom completion of
true degree 1), and a (3,6) QC graph with a phantom edge on a degree-3
variable (true degree 2, which only the per-degree-block loop and the
general table decoder take).  Codecs are designed by the JAX package and
carried across; labels come from a numpy seed.  Tolerance: zero (bits, ok
and iters equal on every frame).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from lut_ldpc_tpu.core import dvbs2 as jax_dvbs2
from lut_ldpc_tpu.core.qc import qc_expand, qc_generate_regular
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.decoder import make_decoder as jax_make_decoder
from lut_ldpc_tpu.decoder.arith import build_arith_spec as jax_arith_spec
from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder as JaxArith
from lut_ldpc_tpu.decoder.lut_decoder import LUTDecoder as JaxLUTDecoder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_carry import carry  # noqa: E402

from lut_ldpc_torch import bench_n64800  # noqa: E402
from lut_ldpc_torch.core import dvbs2  # noqa: E402
from lut_ldpc_torch.core.alist import read_alist_cols  # noqa: E402
from lut_ldpc_torch.decoder import (ArithLUTDecoder, FastLUTDecoder,  # noqa: E402
                                    HybridLUTDecoder, LUTDecoder,
                                    MixedArithDecoder, build_arith_spec,
                                    make_decoder)
from lut_ldpc_torch.decoder import LUTCodec as PortCodec  # noqa: E402
from lut_ldpc_torch.decoder.params import qc_tables  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Z, Q = 16, 4
M = Z * Q
GROUPS = [[0, 9, 34], [3, 21, 46], [1, 6, 11, 36], [2, 7, 23, 16]]
N = len(GROUPS) * Z + M
B = 40


def _true_cols():
    cols = [np.array(sorted((x + t * Q) % M for x in g))
            for g in GROUPS for t in range(Z)]
    cols += [np.array([j] if j == M - 1 else [j, j + 1]) for j in range(M)]
    return cols


def _frames(codec, nframes, seed, sig):
    rng = np.random.default_rng(seed)
    y = 1.0 + sig * rng.standard_normal((nframes, codec.nvar))
    lc, lm = codec.quantize_channel(2.0 * y / sig**2)
    return np.asarray(lc, np.int32), np.asarray(lm, np.int32)


def _assert_golden(codec, lc, lm, out):
    bits, ok, iters = (np.asarray(o) for o in out)
    for f in range(len(lc)):
        want, it = codec.decode_ref(lc[f], lm[f])
        np.testing.assert_array_equal(bits[f], np.asarray(want), err_msg=f"frame {f}")
        assert iters[f] == abs(it) and ok[f] == (it > 0), f"frame {f}"


def _assert_same(out, jax_out):
    for a, b, name in zip(out, jax_out, ("bits", "ok", "iters")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.fixture(scope="module")
def analog(tmp_path_factory):
    """(JAX reload, port codec, col_perm) of the toy DVB-S2 codec."""
    st, col_perm, _ = jax_dvbs2.periodic_qc_structure(_true_cols(), N, M, Z)
    codec = LUTCodec.design(qc_expand(st), 0.9**2, max_iters=10, Nq_Cha=16, Nq_Msg=16)
    j, p = carry(codec, tmp_path_factory.mktemp("ph") / "analog.npz")
    return j, p, col_perm


@pytest.fixture(scope="module")
def td2(tmp_path_factory):
    """(JAX reload, port codec) of a (3,6) QC code, Z=16, with one phantom
    edge on a degree-3 variable."""
    st = qc_generate_regular(3, 6, Z=Z, nb=8, seed=1)
    i = int(np.nonzero(st.base[:, 0] >= 0)[0][0])
    st = dataclasses.replace(st, phantoms=((0, 3, i, (3 + int(st.base[i, 0])) % Z),))
    codec = LUTCodec.design(qc_expand(st), 0.7**2, max_iters=8, Nq_Cha=16, Nq_Msg=16)
    return carry(codec, tmp_path_factory.mktemp("ph") / "td2.npz")


def test_periodic_qc_structure_equals_jax():
    cols = _true_cols()
    a = jax_dvbs2.periodic_qc_structure(cols, N, M, Z)
    b = dvbs2.periodic_qc_structure(cols, N, M, Z)
    assert b[0].Z == a[0].Z and (b[0].mb, b[0].nb) == (a[0].mb, a[0].nb)
    np.testing.assert_array_equal(b[0].base, a[0].base)
    np.testing.assert_array_equal(b[0].base2, a[0].base2)
    assert b[0].phantoms == a[0].phantoms and len(b[0].phantoms) == 1
    assert (b[0].base2 >= 0).sum() == 1
    np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_array_equal(b[2], a[2])
    rng = np.random.default_rng(0)
    bad = [np.sort(rng.choice(16, size=3, replace=False)) for _ in range(32)]
    assert dvbs2.periodic_qc_structure(bad, 32, 16, 8) is None


def test_carried_phantom_codec_and_spec_equal_jax(analog):
    """``codec_from_arrays`` keeps the phantoms; the arithmetic spec carries
    the extra true-degree-1 row that no layout block has."""
    jcodec, pcodec, _ = analog
    assert type(pcodec) is PortCodec
    assert len(pcodec.graph.phantoms) == 1
    assert pcodec.graph.phantoms[0]["edge"] == jcodec.graph.phantoms[0]["edge"]
    assert pcodec.graph.qc.phantoms == jcodec.graph.qc.phantoms
    np.testing.assert_array_equal(pcodec.graph.qc.base2, jcodec.graph.qc.base2)
    for dtype in (np.int16, np.float32):
        sj, sp = jax_arith_spec(jcodec, dtype=dtype), build_arith_spec(pcodec, dtype=dtype)
        assert sj.degrees == sp.degrees and 1 in sp.degrees
        assert 1 not in [int(d) for d in pcodec.graph.vn_degrees]
        assert sj.num_iters == sp.num_iters
        np.testing.assert_array_equal(sj.leaf_cha, sp.leaf_cha)
        for trees_j, trees_p in zip(sj.var_trees + [sj.dec_trees],
                                    sp.var_trees + [sp.dec_trees]):
            for tj, tp in zip(trees_j, trees_p):
                assert tj.structure_key() == tp.structure_key()
                for oj, op in zip(tj.ops, tp.ops):
                    np.testing.assert_array_equal(oj.thresholds, op.thresholds)
                    np.testing.assert_array_equal(oj.levels, op.levels)
                    assert (oj.tie_lo, oj.tie_hi) == (op.tie_lo, op.tie_hi)


def test_qc_tables_take_both_circulants_of_a_weight2_cell(analog):
    _, pcodec, _ = analog
    dec = ArithLUTDecoder(pcodec, "cpu")
    assert dec.loop == "qc" and dec.plan is not None
    st = pcodec.graph.qc
    i, j = (int(x[0]) for x in np.nonzero(st.base2 >= 0))
    tab = qc_tables(dec.plan, dec.layout, "cpu")
    # the variable block of the weight-2 cell reads two rolls of one check
    # block: both shifts of the cell, in ascending order
    r = [nb for _, nb, _, _ in dec.plan.vn_cols].index(
        int(dec.layout.vn_node_pos[j * Z]))
    shifts = [s for (_, s) in dec.plan.vn_cols[r][2]]
    assert int(st.base[i, j]) in shifts and int(st.base2[i, j]) in shifts
    d = len(shifts)
    assert sorted(tab.vn_shift[r, :d].tolist()) == sorted(s % Z for s in shifts)
    assert tab.cn_src.shape[0] == st.mb and tab.vn_src.shape[0] == st.nb


@pytest.mark.parametrize("loop", ["qc", "std", "blocks"])
def test_toy_dvbs2_decode_matches_jax_and_golden(analog, loop, monkeypatch):
    jcodec, pcodec, _ = analog
    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    if loop == "blocks":  # what sends the JAX decoder to its plain loop
        monkeypatch.delenv("LUT_LDPC_PALLAS_INTERPRET")
        monkeypatch.setenv("LUT_LDPC_NO_STD_KERNELS", "1")
    if loop == "std":  # the same graph without its circulant structure
        jcodec, pcodec = (dataclasses.replace(c, graph=_without_qc(c.graph))
                          for c in (jcodec, pcodec))
    lc, lm = _frames(jcodec, B, 3, 0.66)

    dec = make_decoder(pcodec, "cpu")
    if loop == "blocks":
        dec = ArithLUTDecoder(pcodec, "cpu", spec=dec.spec, loop="blocks")
    assert isinstance(dec, ArithLUTDecoder) and dec.loop == loop
    assert [p["td"] for p in dec._ph] == [1]
    out = dec(lc, lm)

    jd = jax_make_decoder(jcodec, early_exit=True)
    assert isinstance(jd, JaxArith) and jd._dtype_np == np.dtype(dec.spec.dtype)
    built = (jd._build_qc_pallas() is not None, jd._build_std_kernels() is not None)
    assert built == {"qc": (True, True), "std": (False, True),
                     "blocks": (False, False)}[loop]
    _assert_same(out, jd(lc, lm))
    _assert_golden(pcodec, lc, lm, out)
    iters = out[2].numpy()
    assert (iters < pcodec.max_iters).any() and (iters == pcodec.max_iters).any()


def _without_qc(graph):
    import copy

    g = copy.copy(graph)
    del g.qc
    return g


def test_funnel_narrows_with_phantom_rows(analog, monkeypatch):
    """The phantom row writes land on the narrowed arrays too."""
    _, pcodec, _ = analog
    lc, lm = _frames(pcodec, 64, 8, 0.62)
    wide = ArithLUTDecoder(pcodec, "cpu")(lc, lm)
    monkeypatch.setenv("LUT_FUNNEL_MIN", "4")
    monkeypatch.setenv("LUT_FUNNEL", "2,4,8")
    from lut_ldpc_torch.decoder.arith_decoder import funnel_widths

    assert funnel_widths(64) == [64, 32, 16, 8]
    narrow = ArithLUTDecoder(pcodec, "cpu")(lc, lm)
    for a, b in zip(wide, narrow):
        assert torch.equal(a, b)
    monkeypatch.setenv("LUT_FUNNEL", "off")
    assert funnel_widths(64) == [64]


def test_unpermuted_realization_decodes_like_the_permuted_one(analog):
    """The true matrix in the alist's numbering with the permuted graph's
    per-variable edge order: a degree-1 variable instead of the phantom, the
    std loop instead of the QC loop, the same frames label for label."""
    _, pcodec, col_perm = analog
    g = pcodec.graph
    g.qc_col_perm, g.qc_row_perm = dvbs2.periodic_qc_structure(_true_cols(), N, M, Z)[1:]
    gu = bench_n64800.unpermuted_graph(g)
    H = np.zeros((M, N), np.uint8)
    for c, rows in enumerate(_true_cols()):
        H[rows, c] = 1
    np.testing.assert_array_equal(gu.to_dense(), H)
    cu = PortCodec.design(gu, 0.9**2, max_iters=10, Nq_Cha=16, Nq_Msg=16)
    lc, lm = _frames(pcodec, B, 4, 0.66)
    a = make_decoder(pcodec, "cpu")(lc, lm)
    du = make_decoder(cu, "cpu")
    assert du.loop == "std" and not du._ph and 1 in [int(d) for d in gu.vn_degrees]
    b = du(lc[:, col_perm], lm[:, col_perm])
    assert torch.equal(a[0][:, col_perm], b[0])
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_true_degree_2_phantom_on_the_block_loop(td2, monkeypatch):
    jcodec, pcodec = td2
    lc, lm = _frames(jcodec, B, 5, 0.7)
    dec = make_decoder(pcodec, "cpu")
    assert isinstance(dec, ArithLUTDecoder) and dec.loop == "blocks"
    assert [p["td"] for p in dec._ph] == [2]
    out = dec(lc, lm)
    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    jd = jax_make_decoder(jcodec, early_exit=True)
    # neither JAX kernel loop takes a phantom node of true degree 2
    assert jd._build_qc_pallas() is None and jd._build_std_kernels() is None
    _assert_same(out, jd(lc, lm))
    _assert_golden(pcodec, lc, lm, out)


def test_general_table_decoder_on_phantom_graphs(analog, td2):
    """``LUTDecoder``: equal to the JAX class and the golden model for true
    degree 1.  For true degree 2 the JAX class reads the phantom node's
    inputs after its degree group's update has overwritten them and misses
    the golden model's iteration count on some frames; the port reads them
    before, and is held to the golden model."""
    jcodec, pcodec, _ = analog
    lc, lm = _frames(jcodec, 24, 9, 0.66)
    out = LUTDecoder(pcodec, "cpu")(lc, lm)
    _assert_same(out, JaxLUTDecoder(jcodec, early_exit=True)(lc, lm))
    _assert_golden(pcodec, lc, lm, out)

    jcodec, pcodec = td2
    lc, lm = _frames(jcodec, 48, 1, 0.7)
    out = LUTDecoder(pcodec, "cpu")(lc, lm)
    _assert_golden(pcodec, lc, lm, out)
    jax_out = JaxLUTDecoder(jcodec, early_exit=True)(lc, lm)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jax_out[0]))
    assert (out[2].numpy() != np.asarray(jax_out[2])).sum() <= 4


def test_decoders_without_pinned_edges_refuse_phantoms(analog):
    _, pcodec, _ = analog
    for cls in (FastLUTDecoder, HybridLUTDecoder, MixedArithDecoder):
        with pytest.raises(ValueError):
            cls(pcodec, "cpu")
    dec = ArithLUTDecoder(pcodec, "cpu")
    B0 = 4
    z = torch.zeros
    with pytest.raises(ValueError):  # the continuation is not phantom-aware
        dec.resume(1, z((B0, N), dtype=torch.int32),
                   z((dec.layout.num_edges_vn, B0), dtype=dec.dtype),
                   z((dec.layout.nvar_pad, B0), dtype=torch.int8),
                   z(B0, dtype=torch.bool), z(B0, dtype=torch.bool),
                   z((dec.layout.nvar_pad, B0), dtype=torch.int8),
                   z(B0, dtype=torch.int32))


def test_real_dvbs2_structure():
    """codes/rate0.50_irreg_dvbs2_N64800.alist factorizes: Z=360, uniform
    check degree 7 over 90 x 180 blocks, 8 weight-2 cells, one phantom (the
    staircase wrap)."""
    cols, nvar, nchk = read_alist_cols(bench_n64800.DVBS2_ALIST)
    st, col_perm, row_perm = dvbs2.periodic_qc_structure(cols, nvar, nchk, 360)
    assert st.Z == 360 and st.mb == 90 and st.nb == 180
    assert st.base2 is not None and (st.base2 >= 0).sum() == 8
    assert st.phantoms == ((179, 359, 0, 0),)
    assert sorted(col_perm) == list(range(nvar)) and sorted(row_perm) == list(range(nchk))
