"""Port std-layout CN/VN passes (plain twins, the CPU path of the kernel
wrappers) against the JAX package's ``cn_std_pass`` / ``vn_std_pass`` run in
Pallas interpret mode.

Two graphs without circulant structure: a small one with mixed degree-class
sizes and a degree-1 variable (padding rows in every class), and the N=500
PEG code of the dv 2-17 ensemble.  The same values (numpy seed) go through
both; only real rows of the standard layout are compared.  The port's std CN
pass takes and returns VN-grouped arrays (its kernel folds the row gathers),
so it is held against ``jnp.take`` by perm_v2c, the JAX kernel, and
``jnp.take`` by perm_c2v, as the JAX std loop runs them.  Tolerance: zero
(values, bits, syndrome and unanimity must be identical).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lut_ldpc_tpu.core.tanner import TannerGraph
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.decoder import qc_kernels as jqk
from lut_ldpc_tpu.decoder.arith import build_arith_prefix_spec as jax_prefix_spec
from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder as JaxArith

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_carry import carry  # noqa: E402
from util_codes import random_regular_H  # noqa: E402

from lut_ldpc_torch.decoder import build_arith_prefix_spec  # noqa: E402
from lut_ldpc_torch.decoder import qc_kernels as qk  # noqa: E402
from lut_ldpc_torch.decoder.arith_decoder import ArithLUTDecoder  # noqa: E402
from lut_ldpc_torch.decoder.hybrid import root_levels  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
KSLOTS = ("thr", "levels", "tie_lo", "tie_hi")


def _mixed_graph():
    H = random_regular_H(96, 3, 6, seed=3).copy()
    H[:, 0] = 0
    H[0, 0] = 1  # a degree-1 variable and an irregular check
    return TannerGraph.from_dense(H)


@pytest.fixture(scope="module")
def codecs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("std_codecs")
    mixed = LUTCodec.design(_mixed_graph(), 0.81, max_iters=6,
                            Nq_Cha=16, Nq_Msg=16)
    peg = LUTCodec.design(
        TannerGraph.from_alist(os.path.join(
            REPO, "codes", "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist")),
        0.90**2, max_iters=8, Nq_Cha=16, Nq_Msg=16)
    return {"mixed": carry(mixed, tmp / "mixed.npz"),
            "peg500": carry(peg, tmp / "peg500.npz")}


def _setup(codecs, which, dtype, monkeypatch):
    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    jcodec, pcodec = codecs[which]
    jd = JaxArith(jcodec, early_exit=True,
                  spec=jax_prefix_spec(jcodec, dtype=dtype))
    spec = build_arith_prefix_spec(pcodec, dtype=dtype)
    port = ArithLUTDecoder(pcodec, "cpu", spec=spec)
    assert port.plan is None and jd._qc_copies is None
    return spec, port, jd


def _values(rng, table, shape):
    return np.asarray(table)[rng.integers(0, len(table), size=shape)]


def _jax_vn(jd, m_new, cha, it):
    lay = jd.layout
    structs = [jd._var_struct[di] for di in jd._spec_di]
    flags = [jd._op_flags[di] for di in jd._spec_di]
    use_tots = [st.ops[0].operands == tuple(range(blk.degree - 1))
                and blk.degree >= 3 and jd._is_int
                for st, blk in zip(structs, lay.vn_blocks)]
    keys = jqk.kernel_op_keys(flags)
    prm_it = [[{ks: op[k][it] for ks, k in zip(KSLOTS, kk)}
               for op, kk in zip(jd._var_xs[jd._spec_di[bi]], keys[bi])]
              for bi in range(len(structs))]
    return jqk.vn_std_pass(jnp.asarray(m_new), jnp.asarray(cha), lay.vn_blocks,
                           lay.nvar_pad, structs, prm_it, use_tots, flags)


def _even_frames(m):
    """Every 4th frame positive: those satisfy every check, so the syndrome
    holds flags of both values."""
    m = m.copy()
    m[:, ::4] = np.abs(m[:, ::4])
    return m


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("which", ["mixed", "peg500"])
def test_cn_std_pass_ref_matches_jax(codecs, which, dtype, monkeypatch):
    """VN-grouped v2c values, padding rows included, through the port's
    folded pass and through gather -> JAX kernel -> gather."""
    spec, port, jd = _setup(codecs, which, dtype, monkeypatch)
    tab = port.tables
    it = spec.num_iters // 2
    m_vn = _even_frames(_values(np.random.default_rng(21), root_levels(spec, it),
                                (tab.rows_vn, B)))

    out, synd = qk.cn_std_pass(torch.as_tensor(m_vn), tab)

    lay = jd.layout
    j_cn, j_synd = jqk.cn_std_pass(jnp.take(jnp.asarray(m_vn), lay.perm_v2c, axis=0),
                                   lay.cn_blocks)
    j_out = jnp.take(j_cn, lay.perm_c2v, axis=0)
    real = tab.vn_real.numpy()
    np.testing.assert_array_equal(out.numpy()[real], np.asarray(j_out)[real])
    np.testing.assert_array_equal(synd.numpy(), np.asarray(j_synd))
    assert synd.any() and not synd.all()
    assert out.dtype == port.dtype
    assert any(b.n_pad > b.num_nodes for b in tab.cn_blocks)  # padding checks
    assert any(b.n_pad > b.num_nodes for b in tab.vn_blocks)  # padding variables


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("which", ["mixed", "peg500"])
def test_cn_std_planes_match_jax(codecs, which, dtype, monkeypatch):
    """The two-min on the CN-grouped slot planes, the middle step of
    cn_std_pass_ref (and on the card of the unfolded route that
    lut_ldpc_torch.profile_cn times), against the JAX kernel on the same
    CN-grouped values."""
    spec, port, jd = _setup(codecs, which, dtype, monkeypatch)
    tab = port.tables
    m_cn = _even_frames(_values(np.random.default_rng(23),
                                root_levels(spec, spec.num_iters // 2), (tab.rows_cn, B)))

    out, synd = qk._cn_planes_ref(torch.as_tensor(m_cn), tab)

    j_out, j_synd = jqk.cn_std_pass(jnp.asarray(m_cn), jd.layout.cn_blocks)
    real = tab.cn_real.numpy()
    np.testing.assert_array_equal(out.numpy()[real], np.asarray(j_out)[real])
    np.testing.assert_array_equal(synd.numpy(), np.asarray(j_synd))


@pytest.mark.parametrize("which", ["mixed", "peg500"])
def test_inv_c2v_inverts_perm_c2v(codecs, which):
    """inv_c2v, the table the CN kernel reads and writes through: the
    inverse of perm_c2v on the real rows (so equal to perm_v2c there), -1 at
    every padding check row."""
    _, pcodec = codecs[which]
    spec = build_arith_prefix_spec(pcodec, dtype=np.int16)
    tab = ArithLUTDecoder(pcodec, "cpu", spec=spec).tables
    inv, c2v, v2c = (t.numpy() for t in (tab.inv_c2v, tab.perm_c2v, tab.perm_v2c))
    vn_real, cn_real = tab.vn_real.numpy(), tab.cn_real.numpy()
    assert inv.shape == (tab.rows_cn,) and inv.dtype == np.int32
    np.testing.assert_array_equal(inv[c2v[vn_real]], vn_real)
    np.testing.assert_array_equal(inv[cn_real], v2c[cn_real])
    pad = np.ones(tab.rows_cn, bool)
    pad[cn_real] = False
    assert pad.any() and (inv[pad] == -1).all()
    assert sorted(inv[cn_real]) == sorted(vn_real)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("which", ["mixed", "peg500"])
def test_vn_std_pass_ref_matches_jax(codecs, which, dtype, monkeypatch):
    spec, port, jd = _setup(codecs, which, dtype, monkeypatch)
    tab = port.tables
    it = spec.num_iters // 2
    rng = np.random.default_rng(22)
    m_new = _values(rng, root_levels(spec, it), (tab.rows_vn, B))
    cha = _values(rng, spec.leaf_cha, (tab.nvar_pad, B))

    out, bits, unan = qk.vn_std_pass(torch.as_tensor(m_new), torch.as_tensor(cha),
                                     it, port.params, tab)

    j_out, j_bits, j_unan = _jax_vn(jd, m_new, cha, it)
    real, nodes = tab.vn_real.numpy(), tab.node_real.numpy()
    np.testing.assert_array_equal(out.numpy()[real], np.asarray(j_out)[real])
    np.testing.assert_array_equal(bits.numpy()[nodes], np.asarray(j_bits)[nodes])
    np.testing.assert_array_equal(unan.numpy(), np.asarray(j_unan))


@pytest.mark.parametrize("which", ["mixed", "peg500"])
def test_std_tables_match_jax_layout(codecs, which):
    """The port's layout of the carried codec is the JAX package's: same
    blocks, same row gathers."""
    jcodec, pcodec = codecs[which]
    spec = build_arith_prefix_spec(pcodec, dtype=np.int16)
    port = ArithLUTDecoder(pcodec, "cpu", spec=spec)
    jd = JaxArith(jcodec, early_exit=True, spec=jax_prefix_spec(jcodec, dtype=np.int16))
    tab = port.tables
    np.testing.assert_array_equal(tab.perm_v2c.numpy(), jd.layout.perm_v2c)
    np.testing.assert_array_equal(tab.perm_c2v.numpy(), jd.layout.perm_c2v)
    want = [[b.node_start, b.n_pad, b.num_nodes, b.degree, b.edge_start]
            for b in jd.layout.vn_blocks]
    np.testing.assert_array_equal(tab.vn_cls.numpy().reshape(-1, 5), want)
    want = [[b.node_start, b.n_pad, b.num_nodes, b.degree, b.edge_start]
            for b in jd.layout.cn_blocks]
    np.testing.assert_array_equal(tab.cn_cls.numpy().reshape(-1, 5), want)


def test_std_wrappers_check_inputs(codecs):
    _, pcodec = codecs["mixed"]
    spec = build_arith_prefix_spec(pcodec, dtype=np.int16)
    port = ArithLUTDecoder(pcodec, "cpu", spec=spec)
    tab = port.tables
    with pytest.raises(TypeError):
        qk.cn_std_pass(torch.zeros((tab.rows_vn, 4), dtype=torch.int32), tab)
    with pytest.raises(ValueError):  # the CN-grouped height: not its input
        qk.cn_std_pass(torch.zeros((tab.rows_cn, 4), dtype=torch.int16), tab)
    m = torch.zeros((tab.rows_vn, 4), dtype=torch.int16)
    cha = torch.zeros((tab.nvar_pad, 4), dtype=torch.int16)
    with pytest.raises(IndexError):
        qk.vn_std_pass(m, cha, port.params.num_iters, port.params, tab)
    with pytest.raises(ValueError):
        qk.vn_std_pass(m, cha[:-1], 0, port.params, tab)
    assert all(v == 0 for v in qk.LAUNCHES.values())  # CPU: twins only


def test_kernel_limits_raise(codecs):
    """What the CUDA kernels are instantiated for is checked before a
    launch: a wider degree or a deeper tree raises instead of overrunning."""
    import dataclasses

    _, pcodec = codecs["peg500"]
    spec = build_arith_prefix_spec(pcodec, dtype=np.int16)
    params = ArithLUTDecoder(pcodec, "cpu", spec=spec).params
    dev = torch.device("cpu")
    assert params.max_ops == 16  # the degree-17 class: a binary tree
    qk._check_vn_limits(params, 17, dev)
    with pytest.raises(ValueError):
        qk._check_vn_limits(params, qk.MAX_DEGREE + 1, dev)
    deep = dataclasses.replace(params, max_ops=qk.MAX_TREE_OPS + 1)
    with pytest.raises(ValueError):
        qk._check_vn_limits(deep, 17, dev)
