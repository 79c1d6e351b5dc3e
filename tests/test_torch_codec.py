"""The port's own host-side codec modules against the JAX package's.

``codec_from_arrays`` carries a codec the JAX package saved across to the
port's ``LUTCodec``; the port's own ``LUTCodec.design`` on the same graph
and sigma must give the same arrays; the scalar golden model of both
packages must decode alike.  Tolerance: zero (the saved arrays and strings
must be equal).
"""

import os
import sys

import numpy as np
import pytest

from lut_ldpc_tpu.core import gf2 as jax_gf2
from lut_ldpc_tpu.core.qc import qc_expand, qc_generate_regular
from lut_ldpc_tpu.core.tanner import TannerGraph as JaxGraph
from lut_ldpc_tpu.decoder import LUTCodec as JaxCodec
from lut_ldpc_tpu.decoder.arith import build_arith_prefix_spec as jax_prefix_spec

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_carry import carry, labels  # noqa: E402

from lut_ldpc_torch import _native  # noqa: E402
from lut_ldpc_torch.core import gf2, qc  # noqa: E402
from lut_ldpc_torch.core.tanner import TannerGraph  # noqa: E402
from lut_ldpc_torch.decoder import (LUTCodec, build_arith_prefix_spec,  # noqa: E402
                                    codec_from_arrays)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEG500 = os.path.join(REPO, "codes", "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist")


def _arrays(codec, path):
    codec.save(str(path))
    with np.load(str(path), allow_pickle=False) as z:
        return dict(z)


def _assert_same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_peg():
    return JaxCodec.design(JaxGraph.from_alist(PEG500), 0.88**2, max_iters=10,
                           Nq_Cha=16, Nq_Msg=16)


@pytest.fixture(scope="module")
def jax_qc():
    g = qc_expand(qc_generate_regular(3, 6, Z=16, nb=8, seed=1))
    return JaxCodec.design(g, 0.85**2, max_iters=10, Nq_Cha=16, Nq_Msg=16)


@pytest.mark.parametrize("which", ["peg", "qc"])
def test_codec_from_arrays_round_trip(which, jax_peg, jax_qc, tmp_path):
    jcodec = {"peg": jax_peg, "qc": jax_qc}[which]
    arrays = _arrays(jcodec, tmp_path / "a.npz")
    pcodec = codec_from_arrays(arrays)
    assert type(pcodec) is LUTCodec and type(pcodec) is not JaxCodec
    _assert_same_arrays(_arrays(pcodec, tmp_path / "b.npz"), arrays)
    assert (getattr(pcodec.graph, "qc", None) is not None) == (which == "qc")
    assert pcodec.max_iters == jcodec.max_iters
    np.testing.assert_array_equal(pcodec.reuse_vec, jcodec.reuse_vec)


@pytest.mark.parametrize("which", ["peg", "qc"])
def test_carried_codec_is_the_reloaded_realization(which, jax_peg, jax_qc,
                                                   tmp_path):
    """Same graph realization on both sides: edge order, layouts inputs and
    the golden model's outputs."""
    jcodec, pcodec = carry({"peg": jax_peg, "qc": jax_qc}[which],
                           tmp_path / "c.npz")
    gj, gp = jcodec.graph, pcodec.graph
    np.testing.assert_array_equal(gj.dv_vec, gp.dv_vec)
    for d in gj.vn_degrees:
        np.testing.assert_array_equal(gj.vn_edge_idx[int(d)], gp.vn_edge_idx[int(d)])
        np.testing.assert_array_equal(gj.vn_node_idx[int(d)], gp.vn_node_idx[int(d)])
    for d in gj.cn_degrees:
        np.testing.assert_array_equal(gj.cn_edge_idx[int(d)], gp.cn_edge_idx[int(d)])
        np.testing.assert_array_equal(gj.cn_var_idx[int(d)], gp.cn_var_idx[int(d)])
    lc, lm = labels(jcodec, 1.5, 3, 4)
    np.testing.assert_array_equal(np.asarray(pcodec.quantize_channel(
        np.linspace(-9, 9, 50))), np.asarray(jcodec.quantize_channel(
            np.linspace(-9, 9, 50))))
    for f in range(3):
        bj, ij = jcodec.decode_ref(lc[f], lm[f])
        bp, ip = pcodec.decode_ref(lc[f], lm[f])
        np.testing.assert_array_equal(np.asarray(bj), np.asarray(bp))
        assert ij == ip


def test_port_design_equals_jax_design(jax_peg, tmp_path):
    """The port's own design chain (ensemble, density evolution, quantizer,
    tree templates, native or numpy routines) on the same graph and sigma."""
    pcodec = LUTCodec.design(TannerGraph.from_alist(PEG500), 0.88**2,
                             max_iters=10, Nq_Cha=16, Nq_Msg=16)
    _assert_same_arrays(_arrays(pcodec, tmp_path / "p.npz"),
                        _arrays(jax_peg, tmp_path / "j.npz"))


def test_port_design_equals_jax_design_qc(jax_qc, tmp_path):
    g = qc.qc_expand(qc.qc_generate_regular(3, 6, Z=16, nb=8, seed=1))
    pcodec = LUTCodec.design(g, 0.85**2, max_iters=10, Nq_Cha=16, Nq_Msg=16)
    _assert_same_arrays(_arrays(pcodec, tmp_path / "p.npz"),
                        _arrays(jax_qc, tmp_path / "j.npz"))


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_arith_spec_equals_jax(jax_peg, tmp_path, dtype):
    jcodec, pcodec = carry(jax_peg, tmp_path / "s.npz")
    sj = jax_prefix_spec(jcodec, dtype=dtype)
    sp = build_arith_prefix_spec(pcodec, dtype=dtype)
    assert sj.num_iters == sp.num_iters and sj.degrees == sp.degrees
    np.testing.assert_array_equal(sj.leaf_cha, sp.leaf_cha)
    np.testing.assert_array_equal(sj.leaf_msg0, sp.leaf_msg0)
    for it in range(sj.num_iters):
        for tj, tp in zip(sj.var_trees[it], sp.var_trees[it]):
            for oj, op in zip(tj.ops, tp.ops):
                assert oj.operands == op.operands
                np.testing.assert_array_equal(oj.thresholds, op.thresholds)
                np.testing.assert_array_equal(oj.levels, op.levels)
                assert (oj.tie_lo, oj.tie_hi) == (op.tie_lo, op.tie_hi)


def test_dvbs2_factorization_equals_jax(tmp_path):
    """The port's copy of core/dvbs2.py: the same Z-periodic structure,
    permutations and phantom-completed graph from the same alist (a Z=8
    analog of the DVB-S2 construction), and the same refusal of a matrix
    without that structure."""
    from lut_ldpc_tpu.core import dvbs2 as jax_dvbs2
    from lut_ldpc_tpu.core.alist import write_alist

    from lut_ldpc_torch.core import dvbs2

    Zt, q = 8, 3
    M = Zt * q
    groups = [[0, 4, 8], [1, 5, 10, 12]]  # the second holds a weight-2 cell
    cols = [sorted((x + t * q) % M for x in g) for g in groups for t in range(Zt)]
    cols += [[j] if j == M - 1 else [j, j + 1] for j in range(M)]
    H = np.zeros((M, len(cols)), np.uint8)
    for c, rows in enumerate(cols):
        H[rows, c] = 1
    path = str(tmp_path / "toy.alist")
    write_alist(path, H)
    gj, cj, rj = jax_dvbs2.load_periodic_alist(path, Z=Zt)
    gp, cp, rp = dvbs2.load_periodic_alist(path, Z=Zt)
    np.testing.assert_array_equal(cj, cp)
    np.testing.assert_array_equal(rj, rp)
    assert gj.qc.phantoms == gp.qc.phantoms and len(gp.phantoms) == 1
    np.testing.assert_array_equal(gj.qc.base, gp.qc.base)
    np.testing.assert_array_equal(gj.qc.base2, gp.qc.base2)
    assert (gp.qc.base2 >= 0).sum() == 1
    np.testing.assert_array_equal(gj.dv_vec, gp.dv_vec)
    for d in gj.vn_degrees:
        np.testing.assert_array_equal(gj.vn_edge_idx[int(d)], gp.vn_edge_idx[int(d)])
    for d in gj.cn_degrees:
        np.testing.assert_array_equal(gj.cn_edge_idx[int(d)], gp.cn_edge_idx[int(d)])
    np.testing.assert_array_equal(gj.to_dense(), gp.to_dense())
    assert [p["edge"] for p in gj.phantoms] == [p["edge"] for p in gp.phantoms]
    with pytest.raises(ValueError):
        dvbs2.load_periodic_alist(PEG500, Z=10)


def test_pack_rows_and_rank_equal_jax():
    rng = np.random.default_rng(0)
    for shape in ((7, 64), (13, 130), (40, 257)):
        M = (rng.random(shape) < 0.3).astype(np.uint8)
        P = gf2.pack_rows(M)
        assert P.dtype == np.uint64
        np.testing.assert_array_equal(P, jax_gf2.pack_rows(M))
        np.testing.assert_array_equal(gf2.unpack_rows(P, shape[1]), M)
        assert gf2.gf2_rank(M) == jax_gf2.gf2_rank(M)


def test_native_library_is_the_ports_own():
    """Built from the root csrc/ into build/torch_kernels/, not loaded from
    the JAX package's build."""
    lib = _native.get_lib()
    if lib is None:
        pytest.skip("no C++ compiler: numpy design path")
    assert os.path.dirname(_native.lib_path()).endswith(os.path.join("build", "torch_kernels"))
    assert os.path.samefile(lib._name, _native.lib_path())
