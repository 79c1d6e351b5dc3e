"""CUDA kernels against their plain-torch twins, on the card.

Marked ``gpu``; skipped where torch sees no CUDA device.  Imports no jax,
so it runs on a GPU machine without JAX:

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: zero on real rows (values, bits, syndrome, unanimity) and on
decoder outputs.  Covers the QC, std and per-degree-block kernels, the
generated VN kernels and the CN frames against the table-driven ones and the
plain versions (both dtypes, an even and an odd batch width), and a
mixed-precision and a phantom-completed decode end to end; the BP baselines
and the simulator on the card against the CPU, and its draws repeatable.
"""

import numpy as np
import pytest
import torch

from lut_ldpc_torch.core import qc
from lut_ldpc_torch.core.tanner import TannerGraph
from lut_ldpc_torch.decoder import (ArithLUTDecoder, HybridLUTDecoder, LUTCodec,
                                    MixedArithDecoder, build_arith_prefix_spec)
from lut_ldpc_torch.decoder import qc_kernels as qk, vn_codegen
from lut_ldpc_torch.decoder.hybrid import root_levels
from lut_ldpc_torch.ops.pmf import snr2sig

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def codec():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = qc.qc_expand(qc.qc_generate_regular(3, 6, Z=40, nb=12, seed=3))
    return LUTCodec.design(g, 0.85**2, max_iters=40, Nq_Cha=16, Nq_Msg=16)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_kernels_match_twins(codec, dtype):
    spec = build_arith_prefix_spec(codec, dtype=dtype)
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
    sig = float(snr2sig(0.5, 1.5))
    rng = np.random.default_rng(1)
    y = 1.0 + sig * rng.standard_normal((64, codec.nvar))
    lc, lm = codec.quantize_channel(2.0 * y / sig**2)
    lc, lm = torch.as_tensor(lc, device="cuda"), torch.as_tensor(lm, device="cuda")
    a = HybridLUTDecoder(codec, "cuda")(lc, lm)
    b = HybridLUTDecoder(codec, "cuda", kernels=False)(lc, lm)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _vn_case(codec, dtype, B):
    """(decoder, iteration, VN input, channel values) on the card."""
    spec = build_arith_prefix_spec(codec, dtype=dtype)
    dec = ArithLUTDecoder(codec, "cuda", spec=spec)
    tab, it = dec.tables, spec.num_iters // 2
    rng = np.random.default_rng(3)
    table = torch.as_tensor(root_levels(spec, it), device="cuda")
    rows = tab.rows_cn if dec.loop == "qc" else tab.rows_vn
    m = table[torch.as_tensor(rng.integers(0, len(table), (rows, B)), device="cuda")]
    leaf = torch.as_tensor(np.asarray(spec.leaf_cha), device="cuda").to(m.dtype)
    cha = leaf[torch.as_tensor(rng.integers(0, len(leaf), (tab.nvar_pad, B)),
                               device="cuda")]
    return dec, it, m, cha


@pytest.mark.parametrize("B", [512, 301])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("which", ["qc", "std"])
def test_generated_vn_kernels_match_table_driven_and_plain(request, which, dtype, B):
    """vn_qc_pass / vn_std_pass: the kernels generated for the spec against
    the table-driven kernel (generic=True) and the plain version; an even
    batch width (several frames a thread) and an odd one."""
    codec = request.getfixturevalue("codec" if which == "qc" else "codec_peg")
    dec, it, m, cha = _vn_case(codec, dtype, B)
    assert dec.loop == which
    vn, ref = ((qk.vn_qc_pass, qk.vn_qc_pass_ref) if which == "qc"
               else (qk.vn_std_pass, qk.vn_std_pass_ref))
    tab, name = dec.tables, f"vn_{which}_pass"
    lib = vn_codegen.library(dec.params, dec.dtype, which)
    assert lib.handle().lut_vn_vec(0, B, 1) == (4 if B % 4 == 0 else 1)
    n0, g0 = qk.LAUNCHES[name], qk.CLASS_LAUNCHES[name]
    got = vn(m, cha, it, dec.params, tab)
    assert qk.LAUNCHES[name] == n0 + 1
    per_pass = len(tab.vn_runs) if which == "qc" else len(tab.vn_blocks)
    assert qk.CLASS_LAUNCHES[name] == g0 + per_pass
    for want in (vn(m, cha, it, dec.params, tab, generic=True),
                 ref(m, cha, it, dec.params, tab)):
        assert torch.equal(got[0][tab.vn_real], want[0][tab.vn_real])
        assert torch.equal(got[1][tab.node_real], want[1][tab.node_real])
        assert torch.equal(got[2], want[2])
    assert qk.CLASS_LAUNCHES[name] == g0 + per_pass  # generic=True adds none


@pytest.mark.parametrize("B", [512, 509])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("which", ["qc", "qc_irregular", "std"])
def test_cn_frames_match_table_driven_and_plain(request, which, dtype, B):
    """cn_qc_pass / cn_std_pass: the CN frames against the table-driven
    kernel (generic=True; for std with the two gathers in torch around it)
    and the plain version, on a VN-grouped input whose padding rows hold
    whatever was there; an even batch width (several frames a thread) and an
    odd one.  QC at check degree 6 and at degrees 8 and 9 (two runs of
    block-rows a pass), std at degrees 8, 9 and 10."""
    codec = request.getfixturevalue(
        {"qc": "codec", "qc_irregular": "codec_qc_irregular", "std": "codec_peg"}[which])
    spec = build_arith_prefix_spec(codec, dtype=dtype)
    dec = ArithLUTDecoder(codec, "cuda", spec=spec, kernels=False)
    which = "std" if which == "std" else "qc"
    assert dec.loop == which
    tab, it = dec.tables, spec.num_iters // 2
    rng = np.random.default_rng(4)
    table = torch.as_tensor(root_levels(spec, it), device="cuda")
    m = table[torch.as_tensor(rng.integers(0, len(table), (tab.rows_vn, B)), device="cuda")]
    m[:, ::5] = m[:, ::5].abs()  # frames that satisfy every check
    cn, ref = ((qk.cn_qc_pass, qk.cn_qc_pass_ref) if which == "qc"
               else (qk.cn_std_pass, qk.cn_std_pass_ref))
    real = tab.cn_real if which == "qc" else tab.vn_real
    name = f"cn_{which}_pass"
    per_pass = len(tab.cn_runs) if which == "qc" else len(tab.cn_blocks)
    is_f32 = int(dtype == np.float32)
    vec = qk._load_cn(is_f32).lut_cn_vec(is_f32, int(tab.max_dc), B, 1)
    assert vec == ((4 if is_f32 else 8) if B % 8 == 0 else 1)
    n0, g0 = qk.LAUNCHES[name], qk.CLASS_LAUNCHES[name]
    got, synd = cn(m, tab)
    assert qk.LAUNCHES[name] == n0 + 1
    assert qk.CLASS_LAUNCHES[name] == g0 + per_pass
    for want, w_synd in (cn(m, tab, generic=True), ref(m, tab)):
        assert torch.equal(got[real], want[real])
        assert torch.equal(synd, w_synd)
    assert synd.any() and not synd.all()
    assert qk.CLASS_LAUNCHES[name] == g0 + per_pass  # generic=True adds none
    if which == "std":  # the unfolded route gives the same values
        from lut_ldpc_torch.profile_cn import unfolded_route

        out, s2 = unfolded_route(m, tab)
        assert torch.equal(out[real], got[real])
        assert torch.equal(s2, synd)


@pytest.fixture(scope="module")
def codec_qc_irregular():
    """The base matrix of the QC N=64800 code (check degrees 8 and 9,
    variable degrees 2, 3, 9 and 17) with its shifts taken modulo Z=24:
    N=2160, the same degree runs on the QC kernels."""
    from lut_ldpc_torch.bench_n64800 import QC_JSON

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = qc.load_qc(QC_JSON)
    Z = 24
    g = qc.qc_expand(qc.QCStructure(Z=Z, mb=s.mb, nb=s.nb,
                                    base=np.where(s.base >= 0, s.base % Z, -1)))
    return LUTCodec.design(g, 0.90**2, max_iters=12, Nq_Cha=16, Nq_Msg=16)


@pytest.fixture(scope="module")
def codec_peg():
    """N=500 PEG code, 12 iterations: int16 validates 10, full f32 11."""
    import os

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    g = TannerGraph.from_alist(os.path.join(
        repo, "codes", "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist"))
    return LUTCodec.design(g, 0.80**2, max_iters=12, Nq_Cha=16, Nq_Msg=16)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_std_kernels_match_twins(codec_peg, dtype):
    spec = build_arith_prefix_spec(codec_peg, dtype=dtype)
    dec = ArithLUTDecoder(codec_peg, "cuda", spec=spec)
    assert dec.plan is None
    tab, it, B = dec.tables, spec.num_iters // 2, 300  # B not a multiple of 256
    rng = np.random.default_rng(0)
    table = torch.as_tensor(root_levels(spec, it), device="cuda")
    m = table[torch.as_tensor(rng.integers(0, len(table), (tab.rows_vn, B)),
                              device="cuda")]
    leaf = torch.as_tensor(np.asarray(spec.leaf_cha), device="cuda").to(m.dtype)
    cha = leaf[torch.as_tensor(rng.integers(0, len(leaf), (tab.nvar_pad, B)),
                               device="cuda")]
    n0 = dict(qk.LAUNCHES)
    m_c2v, synd = qk.cn_std_pass(m, tab)  # VN-grouped in and out
    r_c2v, r_synd = qk.cn_std_pass_ref(m, tab)
    assert torch.equal(m_c2v[tab.vn_real], r_c2v[tab.vn_real])
    assert torch.equal(synd, r_synd)
    m_in = table[torch.as_tensor(rng.integers(0, len(table), (tab.rows_vn, B)),
                                 device="cuda")]
    out, bits, unan = qk.vn_std_pass(m_in, cha, it, dec.params, tab)
    r_out, r_bits, r_unan = qk.vn_std_pass_ref(m_in, cha, it, dec.params, tab)
    assert torch.equal(out[tab.vn_real], r_out[tab.vn_real])
    assert torch.equal(bits[tab.node_real], r_bits[tab.node_real])
    assert torch.equal(unan, r_unan)
    assert qk.LAUNCHES["cn_std_pass"] == n0["cn_std_pass"] + 1
    assert qk.LAUNCHES["vn_std_pass"] == n0["vn_std_pass"] + 1


def test_mixed_kernel_path_matches_twin_path(codec_peg):
    sig = float(snr2sig(0.5, 1.0))
    rng = np.random.default_rng(1)
    y = 1.0 + sig * rng.standard_normal((64, codec_peg.nvar))
    lc, lm = codec_peg.quantize_channel(2.0 * y / sig**2)
    lc, lm = torch.as_tensor(lc, device="cuda"), torch.as_tensor(lm, device="cuda")
    dec = MixedArithDecoder(codec_peg, "cuda")
    qk.reset_launches()
    a = dec(lc, lm)
    assert dec.fin_runs == 1
    for dt in ("int16", "float32"):  # both segments on the generated kernels
        assert qk.LAUNCHES_BY_DTYPE["vn_std_pass", dt] >= 1
    b = MixedArithDecoder(codec_peg, "cuda", kernels=False)(lc, lm)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("B", [300, 297])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_block_kernels_match_plain_versions(codec_peg, dtype, B):
    """cn_block_pass / vn_block_pass on every degree block of the PEG codec
    (variable degrees 2, 3, 9, 17), B not a multiple of 256 (297: one frame a
    thread): the CN block kernel against its plain version, the generated VN
    block kernel against the table-driven one (generic=True) and the plain
    version, one class launch a call; then vn_blocks_pass, the block loop's
    VN pass over all blocks with the c2v gather folded in, against its plain
    version."""
    from lut_ldpc_torch.decoder import block_kernels as bk

    spec = build_arith_prefix_spec(codec_peg, dtype=dtype)
    dec = ArithLUTDecoder(codec_peg, "cuda", spec=spec, loop="blocks")
    assert dec.loop == "blocks"
    it = spec.num_iters // 2
    rng = np.random.default_rng(0)
    table = torch.as_tensor(root_levels(spec, it), device="cuda")
    leaf = torch.as_tensor(np.asarray(spec.leaf_cha), device="cuda").to(table.dtype)
    n0, c0 = dict(qk.LAUNCHES), dict(qk.CLASS_LAUNCHES)
    for blk in dec.layout.cn_blocks:
        d, n, nr = blk.degree, blk.n_pad, blk.num_nodes
        m3 = table[torch.as_tensor(rng.integers(0, len(table), (d, n, B)), device="cuda")]
        out, synd = bk.cn_block_pass(m3, nr)
        r_out, r_synd = bk.cn_block_pass_ref(m3, nr)
        assert torch.equal(out[:, :nr], r_out[:, :nr]) and torch.equal(synd, r_synd)
    for blk, prog in zip(dec.layout.vn_blocks, dec._progs):
        d, n, nr = blk.degree, blk.n_pad, blk.num_nodes
        m3 = table[torch.as_tensor(rng.integers(0, len(table), (d, n, B)), device="cuda")]
        cha = leaf[torch.as_tensor(rng.integers(0, len(leaf), (n, B)), device="cuda")]
        out, bits, unan = bk.run_vn_block(m3, cha, prog, it, nr)
        for r_out, r_bits, r_unan in (bk.run_vn_block(m3, cha, prog, it, nr, generic=True),
                                      bk.run_vn_block_ref(m3, cha, prog, it, nr)):
            assert torch.equal(out[:, :nr], r_out[:, :nr])
            assert torch.equal(bits[:nr], r_bits[:nr]) and torch.equal(unan, r_unan)
    ncn, nvn = len(dec.layout.cn_blocks), len(dec.layout.vn_blocks)
    assert qk.LAUNCHES["cn_block_pass"] == n0["cn_block_pass"] + ncn
    assert qk.LAUNCHES["vn_block_pass"] == n0["vn_block_pass"] + 2 * nvn
    assert qk.CLASS_LAUNCHES["cn_block_pass"] == c0["cn_block_pass"] + ncn
    # the witness adds no class launch
    assert qk.CLASS_LAUNCHES["vn_block_pass"] == c0["vn_block_pass"] + nvn

    tab = dec.tables
    m_cn = table[torch.as_tensor(rng.integers(0, len(table), (tab.rows_cn, B)),
                                 device="cuda")]
    cha = leaf[torch.as_tensor(rng.integers(0, len(leaf), (tab.nvar_pad, B)),
                               device="cuda")]
    out, bits, unan = bk.vn_blocks_pass(m_cn, cha, it, dec._progs, tab)
    r_out, r_bits, r_unan = bk.vn_blocks_pass_ref(m_cn, cha, it, dec._progs, tab)
    assert torch.equal(out[tab.vn_real], r_out[tab.vn_real])
    assert torch.equal(bits[tab.node_real], r_bits[tab.node_real])
    assert torch.equal(unan, r_unan)
    assert qk.CLASS_LAUNCHES["vn_block_pass"] == c0["vn_block_pass"] + 2 * nvn


def _toy_dvbs2():
    """The Z=16 analog of the DVB-S2 construction (one weight-2 cell, one
    phantom edge on the staircase wrap)."""
    from lut_ldpc_torch.core.dvbs2 import periodic_qc_structure

    Z, q = 16, 4
    M = Z * q
    groups = [[0, 9, 34], [3, 21, 46], [1, 6, 11, 36], [2, 7, 23, 16]]
    cols = [np.array(sorted((x + t * q) % M for x in g))
            for g in groups for t in range(Z)]
    cols += [np.array([j] if j == M - 1 else [j, j + 1]) for j in range(M)]
    st, _, _ = periodic_qc_structure(cols, len(cols), M, Z)
    return qc.qc_expand(st)


@pytest.mark.parametrize("loop", ["auto", "blocks"])
def test_phantom_decode_matches_twin_path_and_golden(loop):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codec = LUTCodec.design(_toy_dvbs2(), 0.9**2, max_iters=10, Nq_Cha=16, Nq_Msg=16)
    rng = np.random.default_rng(2)
    y = 1.0 + 0.66 * rng.standard_normal((48, codec.nvar))
    lc, lm = codec.quantize_channel(2.0 * y / 0.66**2)
    lc_d, lm_d = torch.as_tensor(lc, device="cuda"), torch.as_tensor(lm, device="cuda")
    dec = ArithLUTDecoder(codec, "cuda", loop=loop)
    assert dec.loop == ("qc" if loop == "auto" else "blocks") and len(dec._ph) == 1
    qk.reset_launches()
    a = dec(lc_d, lm_d)
    vn = "vn_qc_pass" if loop == "auto" else "vn_block_pass"  # the generated kernels
    assert qk.LAUNCHES[vn] >= 1 and qk.CLASS_LAUNCHES[vn] >= qk.LAUNCHES[vn]
    b = ArithLUTDecoder(codec, "cuda", loop=loop, kernels=False)(lc_d, lm_d)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    bits, ok, iters = (o.cpu().numpy() for o in a)
    for f in range(48):
        want, it = codec.decode_ref(lc[f], lm[f])
        assert np.array_equal(bits[f], np.asarray(want))
        assert iters[f] == abs(it) and ok[f] == (it > 0)


@pytest.mark.parametrize("alg", ["minsum", "nms", "oms", "qllr"])
def test_bp_card_equals_cpu(codec, alg):
    """The BP baselines whose operations are exact: bits, ok and iters on
    the card equal the CPU's, with early exit (the funnel) and without."""
    from lut_ldpc_torch.decoder import BPDecoder

    g = codec.graph
    rng = np.random.default_rng(3)
    y = 1.0 + 0.8 * rng.standard_normal((300, g.nvar))
    llr = (2.0 * y / 0.64).astype(np.float32)
    for early in (True, False):
        want = BPDecoder(g, "cpu", 20, algorithm=alg, early_exit=early)(llr)
        got = BPDecoder(g, "cuda", 20, algorithm=alg, early_exit=early)(
            torch.as_tensor(llr, device="cuda"))
        for w, x in zip(want, got):
            assert x.is_cuda and torch.equal(w, x.cpu())


def _numpy_stream(B, nvar, k):
    """A channel hook with a numpy stream (zero codewords)."""
    def hook(ss, bb, sigma):
        rng = np.random.default_rng([ss, bb])
        s = np.float32(sigma)
        y = (1.0 + s * rng.standard_normal((B, nvar)).astype(np.float32)).astype(np.float32)
        return np.zeros((B, k), np.uint8), (np.float32(2.0) * y / (s * s)), y
    return hook


def test_bersim_under_hook_card_equals_cpu(codec):
    """One stream fed to the simulator on both devices: the LUT and the
    minsum runs count alike."""
    from lut_ldpc_torch.decoder import BPDecoder
    from lut_ldpc_torch.sim import BERSim, BERSimConfig, LDPCConfig, SimConfig

    cfg = BERSimConfig(sim=SimConfig(SNRdB=np.array([1.5, 2.5]), Nframes=512, Nfers=10**9,
                                     batch_size=256), ldpc=LDPCConfig(zero_codeword=True))
    hook = _numpy_stream(256, codec.nvar, codec.k)
    for kw in (lambda d: dict(codec=codec),
               lambda d: dict(bp_decoder=BPDecoder(codec.graph, d, 20, algorithm="minsum"))):
        runs = [BERSim(cfg, codec.graph, d, channel=hook, **kw(d)).run(seed=0, verbose=False)
                for d in ("cpu", "cuda")]
        for name in ("frames", "frame_errors", "data_bit_errors", "uncoded_bit_errors",
                     "decode_iters"):
            assert getattr(runs[0], name).tolist() == getattr(runs[1], name).tolist(), name
        assert runs[1].frame_errors[0] > 0


def test_bersim_card_deterministic(codec):
    """The card's own draws: one seed gives one result, another seed
    another."""
    from lut_ldpc_torch.sim import BERSim, BERSimConfig, LDPCConfig, SimConfig

    cfg = BERSimConfig(sim=SimConfig(SNRdB=np.array([2.0]), Nframes=1024, Nfers=10**9,
                                     batch_size=512), ldpc=LDPCConfig(zero_codeword=True))
    runs = [BERSim(cfg, codec.graph, "cuda", codec=codec).run(seed=s, verbose=False)
            for s in (4, 4, 5)]
    assert runs[0].uncoded_bit_errors.tolist() == runs[1].uncoded_bit_errors.tolist()
    assert runs[0].decode_iters.tolist() == runs[1].decode_iters.tolist()
    assert runs[0].uncoded_bit_errors.tolist() != runs[2].uncoded_bit_errors.tolist()


def test_checks_above_degree_32_on_the_cn_frames():
    """The 10GBase-T (6,32) code has checks of degree 31-33: the CN frames'
    bucket of width 40 against the plain version, and a prefix decode on the
    kernels against the twin path."""
    import os

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    g = TannerGraph.from_alist(os.path.join(repo, "codes", "rate0.84_reg_v6c32_N2048.alist"))
    sig = float(snr2sig(0.84, 3.9))
    codec = LUTCodec.design(g, sig**2, max_iters=8, Nq_Cha=16, Nq_Msg=8)
    for dtype in (np.int16, np.float32):
        spec = build_arith_prefix_spec(codec, dtype=dtype)
        dec = ArithLUTDecoder(codec, "cuda", spec=spec)
        tab, it, B = dec.tables, spec.num_iters // 2, 300
        assert dec.loop == "std" and tab.max_dc == 33
        rng = np.random.default_rng(5)
        table = torch.as_tensor(root_levels(spec, it), device="cuda")
        m = table[torch.as_tensor(rng.integers(0, len(table), (tab.rows_vn, B)),
                                  device="cuda")]
        m_c2v, synd = qk.cn_std_pass(m, tab)
        r_c2v, r_synd = qk.cn_std_pass_ref(m, tab)
        assert torch.equal(m_c2v[tab.vn_real], r_c2v[tab.vn_real])
        assert torch.equal(synd, r_synd)
        y = 1.0 + sig * rng.standard_normal((64, codec.nvar))
        lc, lm = codec.quantize_channel(2.0 * y / sig**2)
        lc, lm = torch.as_tensor(lc, device="cuda"), torch.as_tensor(lm, device="cuda")
        a = dec(lc, lm)
        b = ArithLUTDecoder(codec, "cuda", spec=spec, kernels=False)(lc, lm)
        for x, z in zip(a, b):
            assert torch.equal(x, z)
