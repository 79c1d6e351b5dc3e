"""Port per-degree-block CN/VN passes (the plain versions, which are the
CPU path of ``cn_block_pass`` / ``vn_block_pass``) against the JAX package's
``pallas_kernels.cn_pass`` / ``vn_pass`` run in Pallas TPU interpret mode,
and against the plain value-domain functions ``_cn_minsum_values`` /
``_vn_block_update`` that those kernels replace.

Codec: the irregular QC code of tests/test_qc_irregular.py (variable degrees
2, 3, 9, 17).  One degree block at a time, 16 padded rows of which 13 are
real; the same values (numpy seed, drawn from the spec's value tables) go
through all three (degree 17 skips the interpreted TPU VN kernel, which
takes over ten minutes there).  The JAX kernels take 128 frames (their lane
width); the port takes 8 more, so its batch is no multiple of 128.  Tolerance: zero
(values on real rows, bits, syndrome and unanimity must be identical).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble
from lut_ldpc_tpu.core.qc import qc_expand, qc_generate_irregular
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.decoder import pallas_kernels as jpk
from lut_ldpc_tpu.decoder.arith import build_arith_prefix_spec as jax_prefix_spec
from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder as JaxArith
from lut_ldpc_tpu.decoder.arith_decoder import _loo

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_carry import carry  # noqa: E402

from lut_ldpc_torch.decoder import block_kernels as bk  # noqa: E402
from lut_ldpc_torch.decoder import build_arith_prefix_spec  # noqa: E402
from lut_ldpc_torch.decoder import qc_kernels as qk  # noqa: E402
from lut_ldpc_torch.decoder.arith_decoder import ArithLUTDecoder  # noqa: E402
from lut_ldpc_torch.decoder.hybrid import root_levels  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENS = os.path.join(REPO, "ensembles", "rate0.50_dv02-17_dc08-09_lut_q4.ens")
N_PAD, N_REAL = 16, 13
B_JAX, B_PORT = 128, 136
KSLOTS = ("thr", "levels", "tie_lo", "tie_hi")
# the interpreted TPU VN kernel takes up to a minute at degree 9 and over
# ten at degree 17 even on this small block: degree 17 is held against the
# plain value-domain function alone
INTERPRET_MAX_DEGREE = 9


@pytest.fixture(scope="module")
def codecs(tmp_path_factory):
    st = qc_generate_irregular(LDPCEnsemble.read(ENS), Z=24, nb=60, seed=1)
    codec = LUTCodec.design(qc_expand(st), 0.90**2, max_iters=10,
                            Nq_Cha=16, Nq_Msg=16)
    return carry(codec, tmp_path_factory.mktemp("blk") / "irr.npz")


def _setup(codecs, dtype):
    jcodec, pcodec = codecs
    jd = JaxArith(jcodec, early_exit=True, spec=jax_prefix_spec(jcodec, dtype=dtype))
    spec = build_arith_prefix_spec(pcodec, dtype=dtype)
    return jd, spec


def _values(rng, table, shape):
    return np.asarray(table)[rng.integers(0, len(table), size=shape)]


def _port_prm(tree):
    return [dict(thr=op.thresholds, levels=op.levels, tie_lo=op.tie_lo,
                 tie_hi=op.tie_hi) for op in tree.ops]


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_cn_block_pass_ref_matches_jax(codecs, dtype):
    jd, spec = _setup(codecs, dtype)
    it = spec.num_iters // 2
    rng = np.random.default_rng(31)
    degrees = [blk.degree for blk in jd.layout.cn_blocks]
    assert len(degrees) >= 2
    for d in degrees:
        m3 = _values(rng, root_levels(spec, it), (d, N_PAD, B_PORT))
        assert m3.dtype == np.dtype(dtype)
        out, synd = bk.cn_block_pass(torch.as_tensor(m3), N_REAL)
        assert out.dtype == torch.as_tensor(m3).dtype and synd.dtype == torch.bool

        mj = jnp.asarray(m3[:, :, :B_JAX])
        with pltpu.force_tpu_interpret_mode():
            j_out, j_synd = jpk.cn_pass(mj, N_REAL)
        np.testing.assert_array_equal(out.numpy()[:, :N_REAL, :B_JAX],
                                      np.asarray(j_out)[:, :N_REAL])
        np.testing.assert_array_equal(synd.numpy()[:B_JAX], np.asarray(j_synd))
        # the plain value-domain function, all port frames
        want = np.asarray(jd._cn_minsum_values(jnp.asarray(m3)))
        np.testing.assert_array_equal(out.numpy()[:, :N_REAL], want[:, :N_REAL])
        par = (m3[:, :N_REAL] < 0).sum(axis=0) & 1
        np.testing.assert_array_equal(synd.numpy(), ~par.any(axis=0))


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("degree", [2, 3, 9, 17])
def test_vn_block_pass_ref_matches_jax(codecs, degree, dtype):
    jd, spec = _setup(codecs, dtype)
    it = spec.num_iters // 2
    bi = [blk.degree for blk in jd.layout.vn_blocks].index(degree)
    blk = jd.layout.vn_blocks[bi]
    di = jd._spec_di[bi]
    assert spec.degrees[di] == degree
    rng = np.random.default_rng(32 + degree)
    m3 = _values(rng, root_levels(spec, it), (degree, N_PAD, B_PORT))
    cha = _values(rng, spec.leaf_cha, (N_PAD, B_PORT))
    struct = jd._var_struct[di]
    use_tot = bool(struct.ops[0].operands == tuple(range(degree - 1))
                   and degree >= 3 and jd._is_int)
    loo = _loo(degree)

    out, bits, unan = bk.vn_block_pass(
        torch.as_tensor(m3), torch.as_tensor(cha), spec.var_trees[it][di],
        _port_prm(spec.var_trees[it][di]), loo, use_tot, N_REAL)
    assert bits.dtype == torch.uint8 and unan.dtype == torch.bool

    prm_it = [{k: np.asarray(v)[it] for k, v in op.items()} for op in jd._var_xs[di]]
    if degree <= INTERPRET_MAX_DEGREE:
        # the TPU kernel, with the four parameter slots
        # examples/profile_pallas.py hands it
        with pltpu.force_tpu_interpret_mode():
            j_out, j_bits, j_unan = jpk.vn_pass(
                jnp.asarray(m3[:, :, :B_JAX]), jnp.asarray(cha[:, :B_JAX]), struct,
                [{k: p[k] for k in KSLOTS} for p in prm_it], loo, use_tot, N_REAL)
        np.testing.assert_array_equal(out.numpy()[:, :N_REAL, :B_JAX],
                                      np.asarray(j_out)[:, :N_REAL])
        np.testing.assert_array_equal(bits.numpy()[:N_REAL, :B_JAX],
                                      np.asarray(j_bits)[:N_REAL])
        # the port's flag covers 8 frames more: recompute it for the shared ones
        neg = out.numpy()[:, :N_REAL, :B_JAX] < 0
        np.testing.assert_array_equal((neg == neg[:1]).all(axis=(0, 1)),
                                      np.asarray(j_unan))

    # the plain value-domain function, all port frames
    want = np.asarray(jd._vn_block_update(
        bi, blk, jnp.asarray(m3), jnp.asarray(cha),
        [{k: jnp.asarray(v) for k, v in p.items()} for p in prm_it]))
    np.testing.assert_array_equal(out.numpy()[:, :N_REAL], want[:, :N_REAL])
    wneg = want[:, :N_REAL] < 0
    np.testing.assert_array_equal(bits.numpy()[:N_REAL], wneg[0].astype(np.uint8))
    np.testing.assert_array_equal(unan.numpy(), (wneg == wneg[:1]).all(axis=(0, 1)))


def test_block_program_equals_single_iteration_calls(codecs):
    """A decoder's packed program over all iterations gives, at iteration
    it, what ``vn_block_pass`` gives for that iteration's parameters."""
    _, pcodec = codecs
    spec = build_arith_prefix_spec(pcodec, dtype=np.int16)
    dec = ArithLUTDecoder(pcodec, "cpu", spec=spec, loop="blocks")
    assert dec.loop == "blocks" and dec.plan is None
    rng = np.random.default_rng(5)
    for it in (0, spec.num_iters - 1):
        table = root_levels(spec, it) if it else spec.leaf_msg0
        for bi, (blk, prog) in enumerate(zip(dec.layout.vn_blocks, dec._progs)):
            d = blk.degree
            di = spec.degrees.index(d)
            m3 = torch.as_tensor(_values(rng, table, (d, N_PAD, 5)))
            cha = torch.as_tensor(_values(rng, spec.leaf_cha, (N_PAD, 5)))
            a = bk.run_vn_block(m3, cha, prog, it, N_REAL)
            tree = spec.var_trees[it][di]
            b = bk.vn_block_pass(m3, cha, tree, _port_prm(tree), prog.loo,
                                 prog.use_tot, N_REAL)
            assert torch.equal(a[0][:, :N_REAL], b[0][:, :N_REAL])
            assert torch.equal(a[1][:N_REAL], b[1][:N_REAL]) and torch.equal(a[2], b[2])


def test_block_wrappers_check_inputs(codecs):
    _, pcodec = codecs
    spec = build_arith_prefix_spec(pcodec, dtype=np.int16)
    tree = spec.var_trees[0][spec.degrees.index(3)]
    prm = _port_prm(tree)
    m3 = torch.zeros((3, N_PAD, 4), dtype=torch.int16)
    cha = torch.zeros((N_PAD, 4), dtype=torch.int16)
    with pytest.raises(TypeError):
        bk.cn_block_pass(m3.to(torch.int32), N_REAL)
    with pytest.raises(ValueError):
        bk.cn_block_pass(m3, N_PAD + 1)
    with pytest.raises(ValueError):
        bk.cn_block_pass(m3.permute(1, 0, 2), N_REAL)  # not contiguous
    with pytest.raises(ValueError):
        bk.vn_block_pass(m3, cha[:-1], tree, prm, _loo(3), False, N_REAL)
    with pytest.raises(ValueError):  # a table of another degree
        bk.vn_block_pass(m3, cha, tree, prm, _loo(4), False, N_REAL)
    with pytest.raises(ValueError):  # parameters of fewer ops than the tree
        bk.vn_block_pass(m3, cha, tree, prm[:-1], _loo(3), False, N_REAL)
    bad = [dict(p, levels=np.asarray(p["levels"])[:-1]) for p in prm]
    with pytest.raises(ValueError):  # levels do not match the thresholds
        bk.vn_block_pass(m3, cha, tree, bad, _loo(3), False, N_REAL)
    prog = bk.vn_block_program(tree, [prm], _loo(3), False, "cpu")
    with pytest.raises(IndexError):
        bk.run_vn_block(m3, cha, prog, 1, N_REAL)
    assert qk.LAUNCHES["cn_block_pass"] == 0 and qk.LAUNCHES["vn_block_pass"] == 0
