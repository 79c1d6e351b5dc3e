"""CUDA kernels against their plain-torch twins, on the card.

Marked ``gpu``; skipped where torch sees no CUDA device.  Imports no jax,
so it runs on a GPU machine without JAX:

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: zero on real rows (values, bits, syndrome, unanimity) and on
decoder outputs.
"""

import numpy as np
import pytest
import torch

from lut_ldpc_torch import _ref
from lut_ldpc_torch.decoder import ArithLUTDecoder, HybridLUTDecoder
from lut_ldpc_torch.decoder import qc_kernels as qk
from lut_ldpc_torch.decoder.hybrid import root_levels

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def codec():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qc = _ref.qc.qc_generate_regular(3, 6, Z=40, nb=12, seed=3)
    return _ref.LUTCodec.design(_ref.qc.qc_expand(qc), 0.85**2, max_iters=40,
                                Nq_Cha=16, Nq_Msg=16)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_kernels_match_twins(codec, dtype):
    spec = _ref.build_arith_prefix_spec(codec, dtype=dtype)
    dec = ArithLUTDecoder(codec, "cuda", spec=spec)
    tab, it, B = dec.tables, spec.num_iters // 2, 300  # B not a multiple of 256
    rng = np.random.default_rng(0)
    table = torch.as_tensor(root_levels(spec, it), device="cuda")
    m_vn = table[torch.as_tensor(rng.integers(0, len(table), (tab.rows_vn, B)),
                                 device="cuda")]
    leaf = torch.as_tensor(np.asarray(spec.leaf_cha), device="cuda").to(m_vn.dtype)
    cha = leaf[torch.as_tensor(rng.integers(0, len(leaf), (tab.nvar_pad, B)),
                               device="cuda")]
    n0 = dict(qk.LAUNCHES)
    m_cn, synd = qk.cn_qc_pass(m_vn, tab)
    r_cn, r_synd = qk.cn_qc_pass_ref(m_vn, tab)
    assert torch.equal(m_cn[tab.cn_real], r_cn[tab.cn_real])
    assert torch.equal(synd, r_synd)
    out, bits, unan = qk.vn_qc_pass(r_cn, cha, it, dec.params, tab)
    r_out, r_bits, r_unan = qk.vn_qc_pass_ref(r_cn, cha, it, dec.params, tab)
    assert torch.equal(out[tab.vn_real], r_out[tab.vn_real])
    assert torch.equal(bits[tab.node_real], r_bits[tab.node_real])
    assert torch.equal(unan, r_unan)
    assert qk.LAUNCHES["cn_qc_pass"] == n0["cn_qc_pass"] + 1
    assert qk.LAUNCHES["vn_qc_pass"] == n0["vn_qc_pass"] + 1


def test_hybrid_kernel_path_matches_twin_path(codec):
    sig = float(_ref.pmf.snr2sig(0.5, 1.5))
    rng = np.random.default_rng(1)
    y = 1.0 + sig * rng.standard_normal((64, codec.nvar))
    lc, lm = codec.quantize_channel(2.0 * y / sig**2)
    lc, lm = torch.as_tensor(lc, device="cuda"), torch.as_tensor(lm, device="cuda")
    a = HybridLUTDecoder(codec, "cuda")(lc, lm)
    b = HybridLUTDecoder(codec, "cuda", kernels=False)(lc, lm)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
