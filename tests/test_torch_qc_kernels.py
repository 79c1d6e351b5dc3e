"""Port CN/VN passes (plain twins, the CPU path of the kernel wrappers)
against the JAX package.

On the regular (3,6) code the JAX side is its Pallas kernels run in
interpret mode; their halo-plane layout is mapped with
``std_to_kernel_rows``.  On the irregular code (VN classes up to dv=17,
whose unrolled tree takes ~25 s to trace per interpret-mode call) it is
the JAX decoder's plain XLA path over the same passes (roll permutes,
``_cn_minsum_values``, ``_vn_block_update``), which the JAX suite holds
bit-identical to the kernels.  Only real rows of the standard layout are
compared.  Tolerance: zero (values, bits, syndrome and unanimity must be
identical).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble
from lut_ldpc_tpu.core.qc import qc_expand, qc_generate_irregular, qc_generate_regular
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.decoder import qc_kernels as jqk
from lut_ldpc_tpu.decoder.arith import build_arith_prefix_spec, build_arith_spec
from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder as JaxArith

from lut_ldpc_torch.decoder import qc_kernels as qk
from lut_ldpc_torch.decoder.arith_decoder import ArithLUTDecoder
from lut_ldpc_torch.decoder.hybrid import root_levels

torch.set_num_threads(1)

B = 24
KSLOTS = ("thr", "levels", "tie_lo", "tie_hi")


@pytest.fixture(scope="module")
def codecs():
    reg = LUTCodec.design(qc_expand(qc_generate_regular(3, 6, Z=40, nb=12, seed=3)),
                          0.85**2, max_iters=40, Nq_Cha=16, Nq_Msg=16)
    e = LDPCEnsemble.read("ensembles/rate0.50_dv02-17_dc08-09_lut_q4.ens")
    irr = LUTCodec.design(qc_expand(qc_generate_irregular(e, Z=24, nb=60, seed=1)),
                          0.90**2, max_iters=10, Nq_Cha=16, Nq_Msg=16)
    return {"regular": reg, "irregular": irr}


def _setup(codecs, which, dtype, monkeypatch):
    if which == "regular":
        monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    codec = codecs[which]
    spec = (build_arith_prefix_spec(codec, dtype=dtype) if which == "regular"
            else build_arith_spec(codec, dtype=dtype))
    port = ArithLUTDecoder(codec, "cpu", spec=spec)
    jd = JaxArith(codec, early_exit=True, spec=spec)
    assert jd._qc_copies is not None
    return codec, spec, port, jd


def _to_halo(m_std, krows, rows, stride, Z, halo):
    """Standard grouped rows -> the JAX kernels' halo-plane layout."""
    out = np.zeros((rows, m_std.shape[1]), m_std.dtype)
    real = krows >= 0
    out[krows[real]] = m_std[real]
    for p0 in range(0, rows, stride):
        for q in range(halo):
            out[p0 + Z + q] = out[p0 + q % Z]
    return out


def _pallas_cn(jd, m_vn, dtype):
    """JAX CN kernel (interpret mode) -> standard-layout rows, synd."""
    plan, lay = jd._qcp, jd.layout
    geom = jqk.qc_geometry(plan, B, np.dtype(dtype).itemsize)
    k_vn = jqk.std_to_kernel_rows(plan, geom, "vn", lay.num_edges_vn)
    k_cn = jqk.std_to_kernel_rows(plan, geom, "cn", lay.num_edges_cn)
    km = _to_halo(m_vn, k_vn, geom.rows_vn, plan.Z + geom.halo_vn, plan.Z,
                  geom.halo_vn)
    out, synd = jqk.cn_qc_pass(jnp.asarray(km), plan, geom)
    return np.asarray(out)[np.maximum(k_cn, 0)], np.asarray(synd)


def _pallas_vn(jd, m_cn, cha, it, dtype):
    """JAX VN kernel (interpret mode) -> standard-layout rows, bits, unan."""
    plan, lay = jd._qcp, jd.layout
    geom = jqk.qc_geometry(plan, B, np.dtype(dtype).itemsize)
    k_vn = jqk.std_to_kernel_rows(plan, geom, "vn", lay.num_edges_vn)
    k_cn = jqk.std_to_kernel_rows(plan, geom, "cn", lay.num_edges_cn)
    kc = _to_halo(m_cn, k_cn, geom.rows_cn, plan.Z + geom.halo_cn, plan.Z,
                  geom.halo_cn)
    structs = [jd._var_struct[di] for di in jd._spec_di]
    flags = [jd._op_flags[di] for di in jd._spec_di]
    use_tots = [st.ops[0].operands == tuple(range(blk.degree - 1))
                and blk.degree >= 3 and jd._is_int
                for st, blk in zip(structs, lay.vn_blocks)]
    keys = jqk.kernel_op_keys(flags)
    prm_it = [[{ks: op[k][it] for ks, k in zip(KSLOTS, kk)}
               for op, kk in zip(jd._var_xs[jd._spec_di[bi]], keys[bi])]
              for bi in range(len(structs))]
    out, bits, unan = jqk.vn_qc_pass(
        jnp.asarray(kc), jnp.asarray(cha), plan, geom, lay.nvar_pad, structs,
        prm_it, use_tots, flags)
    return (np.asarray(out)[np.maximum(k_vn, 0)], np.asarray(bits),
            np.asarray(unan))


def _xla_cn(jd, m_vn, dtype):
    """JAX decoder's XLA CN step on the standard layout."""
    m_cn = jd._permute_v2c(jnp.asarray(m_vn))
    outs, synd = [], None
    for bi, m in enumerate(jd._cn_blocks_of(m_cn)):
        outs.append(jd._cn_minsum_values(m).reshape(-1, B))
        s = jnp.sum((m < 0).astype(jnp.int32), axis=0) & 1
        ok = jnp.all((s == 0) | jd._cn_padmask[bi][:, None], axis=0)
        synd = ok if synd is None else synd & ok
    return np.asarray(jnp.concatenate(outs, axis=0)), np.asarray(synd)


def _xla_vn(jd, m_cn, cha, it, dtype):
    """JAX decoder's XLA VN step (_vn_block_update) on the standard layout."""
    m_new = jd._permute_c2v(jnp.asarray(m_cn))
    prm = jax.tree_util.tree_map(lambda a: a[it], jd._var_xs)
    outs, bits, unan = [], [], None
    for bi, blk in enumerate(jd.layout.vn_blocks):
        d, n, e0 = blk.degree, blk.n_pad, blk.edge_start
        m = m_new[e0 : e0 + n * d].reshape(d, n, B)
        cha_b = jnp.asarray(cha[blk.node_start : blk.node_start + n])
        out = jd._vn_block_update(bi, blk, m, cha_b, prm[jd._spec_di[bi]])
        outs.append(out.reshape(-1, B))
        neg = out < 0
        bits.append(neg[0].astype(jnp.int8))
        agree = jnp.all(jnp.all(neg == neg[:1], axis=0)
                        | jd._vn_padmask[bi][:, None], axis=0)
        unan = agree if unan is None else unan & agree
    return (np.asarray(jnp.concatenate(outs, axis=0)),
            np.asarray(jnp.concatenate(bits, axis=0)), np.asarray(unan))


def _values(rng, table, shape):
    return np.asarray(table)[rng.integers(0, len(table), size=shape)]


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("which", ["regular", "irregular"])
def test_cn_qc_pass_ref_matches_jax(codecs, which, dtype, monkeypatch):
    _, spec, port, jd = _setup(codecs, which, dtype, monkeypatch)
    tab, lay = port.tables, port.layout
    it = spec.num_iters // 2
    rng = np.random.default_rng(11)
    m_vn = _values(rng, root_levels(spec, it), (lay.num_edges_vn, B))

    m_cn, synd = qk.cn_qc_pass(torch.as_tensor(m_vn), tab)

    j_cn, j_synd = (_pallas_cn if which == "regular" else _xla_cn)(jd, m_vn, dtype)
    real = tab.cn_real.numpy()
    np.testing.assert_array_equal(m_cn.numpy()[real], j_cn[real])
    np.testing.assert_array_equal(synd.numpy(), j_synd)
    assert m_cn.dtype == port.dtype


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("which", ["regular", "irregular"])
def test_vn_qc_pass_ref_matches_jax(codecs, which, dtype, monkeypatch):
    _, spec, port, jd = _setup(codecs, which, dtype, monkeypatch)
    tab, lay = port.tables, port.layout
    it = spec.num_iters // 2
    rng = np.random.default_rng(12)
    m_vn = _values(rng, root_levels(spec, it), (lay.num_edges_vn, B))
    cha = _values(rng, spec.leaf_cha, (lay.nvar_pad, B))
    m_cn, _ = qk.cn_qc_pass(torch.as_tensor(m_vn), tab)
    m_cn = m_cn.numpy()
    m_cn[np.setdiff1d(np.arange(lay.num_edges_cn), tab.cn_real.numpy())] = 0

    out, bits, unan = qk.vn_qc_pass(torch.as_tensor(m_cn), torch.as_tensor(cha),
                                    it, port.params, tab)

    j_out, j_bits, j_unan = (_pallas_vn if which == "regular" else _xla_vn)(
        jd, m_cn, cha, it, dtype)
    real = tab.vn_real.numpy()
    np.testing.assert_array_equal(out.numpy()[real], j_out[real])
    nodes = tab.node_real.numpy()
    np.testing.assert_array_equal(bits.numpy()[nodes], j_bits[nodes])
    np.testing.assert_array_equal(unan.numpy(), j_unan)

def test_wrappers_check_inputs(codecs):
    codec = codecs["regular"]
    port = ArithLUTDecoder(codec, "cpu", spec=build_arith_prefix_spec(codec, dtype=np.int16))
    tab = port.tables
    with pytest.raises(TypeError):
        qk.cn_qc_pass(torch.zeros((tab.rows_vn, 4), dtype=torch.int32), tab)
    with pytest.raises(ValueError):
        qk.cn_qc_pass(torch.zeros((tab.rows_vn + 1, 4), dtype=torch.int16), tab)
    m_cn = torch.zeros((tab.rows_cn, 4), dtype=torch.int16)
    with pytest.raises(IndexError):
        qk.vn_qc_pass(m_cn, torch.zeros((tab.nvar_pad, 4), dtype=torch.int16),
                      port.params.num_iters, port.params, tab)
    assert qk.LAUNCHES == {"cn_qc_pass": 0, "vn_qc_pass": 0}  # CPU: twins only
