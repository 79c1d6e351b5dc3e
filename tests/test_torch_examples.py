"""The port's example workflows (lut_ldpc_torch/examples) against the JAX
package's (examples/ at the repo root, loaded from their paths) on the CPU.

The simulating modules are held equal through the ``channel=`` hook, which
feeds the port exactly the JAX simulator's stream (tests/torch_carry.py):
their counters must then be equal per SNR point (tolerance zero).  The
host-side outputs are exact too: the stability numbers of the stored
dvbs2_lut run within rtol 1e-12 (host float64), the stored TPU-era codecs
array for array, the generated assets byte for byte, the example tree's
TikZ text.  Sizes: the N=500 irregular PEG code and the toy Z=16 analog of
the DVB-S2 matrix, 10-50 iterations, 64-128 frames.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from lut_ldpc_tpu import sim as jsim
from lut_ldpc_tpu.core import dvbs2 as jax_dvbs2
from lut_ldpc_tpu.core.tanner import TannerGraph as JaxGraph
from lut_ldpc_tpu.decoder import LUTCodec as JaxCodec
from lut_ldpc_tpu.decoder.arith import ArithBuildError as JaxArithBuildError
from lut_ldpc_tpu.decoder.arith import build_arith_prefix_spec as jax_prefix_spec
from lut_ldpc_tpu.decoder.arith import build_arith_spec as jax_arith_spec
from lut_ldpc_tpu.decoder.bp import BPDecoder as JaxBP
from lut_ldpc_tpu.design.de import get_lam2stable_lut as jax_lam2stable
from lut_ldpc_tpu.ops.pmf import snr2sig as jax_snr2sig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_carry import carry, jax_stream  # noqa: E402

from lut_ldpc_torch.core import dvbs2  # noqa: E402
from lut_ldpc_torch.core.alist import write_alist  # noqa: E402
from lut_ldpc_torch.core.gf2 import gf2_rank  # noqa: E402
from lut_ldpc_torch.core.tanner import TannerGraph  # noqa: E402
from lut_ldpc_torch.core.trees import serialize_tree_array  # noqa: E402
from lut_ldpc_torch.decoder import BPDecoder, LUTCodec  # noqa: E402
from lut_ldpc_torch.decoder.arith import (ArithBuildError,  # noqa: E402
                                          build_arith_prefix_spec, build_arith_spec)
from lut_ldpc_torch.examples import (ber_waterfall, dvbs2_qc_equivalence,  # noqa: E402
                                     dvbs2_waterfall, make_assets, render_tree_example)
from lut_ldpc_torch.sim import BERSimResults  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WATERFALL = os.path.join(REPO, "docs", "waterfall")
PEG500 = os.path.join(REPO, "codes", "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist")
BUDGET = "LUT_DECODE_MEM_BUDGET"
# the toy analog of the DVB-S2 construction (tests/test_torch_phantom.py):
# Z=16, info column groups with one weight-2 cell, an accumulator
# staircase whose wrap misses one edge (one phantom of true degree 1)
Z, Q = 16, 4
M = Z * Q
GROUPS = [[0, 9, 34], [3, 21, 46], [1, 6, 11, 36], [2, 7, 23, 16]]


def _jax_example(name):
    """The JAX package's example script `name` loaded from its path; the
    memory budget it sets at import is taken back out."""
    before = os.environ.get(BUDGET)
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if before is None:
        os.environ.pop(BUDGET, None)
    else:
        os.environ[BUDGET] = before
    return mod


@pytest.fixture(autouse=True)
def _budget(monkeypatch):
    """The examples set the memory budget where it is unset: keep that
    inside each test."""
    monkeypatch.setenv(BUDGET, str(dvbs2_waterfall.MEM_BUDGET))


def _jax_cfg(snrs, frames, batch, **kw):
    return jsim.BERSimConfig(
        sim=jsim.SimConfig(SNRdB=np.asarray(snrs, dtype=np.float64), Nframes=frames,
                           batch_size=batch, **kw),
        ldpc=jsim.LDPCConfig(zero_codeword=True))


def _load(path):
    return BERSimResults.load(path)


def _same_results(a, b):
    for name in ("frames", "data_bits", "uncoded_bits", "frame_errors",
                 "data_bit_errors", "uncoded_bit_errors", "decode_iters"):
        assert getattr(a, name).tolist() == getattr(b, name).tolist(), name
    np.testing.assert_array_equal(a.mean_iters(), b.mean_iters())


# -- dvbs2_waterfall ----------------------------------------------------------
@pytest.fixture(scope="module")
def peg500_codecs(tmp_path_factory):
    """(JAX reload, port codec) of a q4 codec designed at 0.90 on the N=500
    irregular PEG code, 10 iterations."""
    codec = JaxCodec.design(JaxGraph.from_alist(PEG500), 0.90**2, max_iters=10,
                            Nq_Cha=16, Nq_Msg=16)
    return carry(codec, tmp_path_factory.mktemp("c") / "peg500.npz")


@pytest.mark.parametrize("kind", ["lut", "bp_minsum"])
def test_run_one_equals_jax(peg500_codecs, tmp_path, kind):
    """run_one's payload and files: frames, frame errors, BER, FER and mean
    iterations equal to the JAX script's run_one under the JAX stream."""
    jex = _jax_example("dvbs2_waterfall")
    jcodec, pcodec = peg500_codecs
    snr, frames, batch = np.array([1.5, 2.5]), 128, 64
    hook = jax_stream(_jax_cfg(snr, frames, batch), jcodec.k, jcodec.nvar, None, 0)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    if kind == "lut":
        want = jex.run_one("w", jcodec.graph, snr, frames, batch, jdir, codec=jcodec)
        got = dvbs2_waterfall.run_one("w", pcodec.graph, snr, frames, batch, pdir,
                                      codec=pcodec, device="cpu", channel=hook)
    else:
        want = jex.run_one("w", jcodec.graph, snr, frames, batch, jdir,
                           bp=JaxBP(jcodec.graph, 10, algorithm="minsum"))
        got = dvbs2_waterfall.run_one(
            "w", pcodec.graph, snr, frames, batch, pdir, device="cpu", channel=hook,
            bp=BPDecoder(pcodec.graph, "cpu", 10, algorithm="minsum"))
    assert sorted(got) == sorted(want)
    for key in ("snr_db", "frames", "frame_errors", "ber", "fer"):
        assert got[key] == want[key], key
    assert sum(got["frame_errors"]) > 0 and got["frames"][0] == frames
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == ["w.it", "w.json", "w.npz"]
    _same_results(_load(os.path.join(pdir, "w.npz")), _load(os.path.join(jdir, "w.npz")))


def test_runs_match_the_jax_script():
    """The five runs: codes, tags and SNR grids as the JAX script has them."""
    from lut_ldpc_torch.sim.config import _parse_range

    assert list(dvbs2_waterfall.TAGS) == ["lut64800", "lut64800_qc", "dvbs2_spa",
                                          "dvbs2_lut", "dvbs2_lut_qc"]
    assert list(dvbs2_waterfall.TAGS.values()) == [
        "lut_dv02-17_N64800_q4", "lut_dv02-17_N64800_qc_q4", "dvbs2_N64800_spa",
        "dvbs2_N64800_lut_q4", "dvbs2_N64800_lut_q4_qc"]
    np.testing.assert_allclose(_parse_range(dvbs2_waterfall.SNR["lut64800"]),
                               [0.8, 1.0, 1.2, 1.4, 1.6])
    with open(os.path.join(WATERFALL, "lut_dv02-17_N64800_q4.json")) as f:
        np.testing.assert_allclose(_parse_range(dvbs2_waterfall.SNR["lut64800"]),
                                   json.load(f)["snr_db"], rtol=0, atol=1e-12)
    with open(os.path.join(WATERFALL, "dvbs2_N64800_lut_q4.json")) as f:
        np.testing.assert_array_equal(_parse_range(dvbs2_waterfall.SNR["dvbs2_lut"]),
                                      json.load(f)["snr_db"])
    with open(os.path.join(WATERFALL, "dvbs2_N64800_spa.json")) as f:
        np.testing.assert_allclose(_parse_range(dvbs2_waterfall.SNR["dvbs2_spa"]),
                                   json.load(f)["snr_db"], rtol=0, atol=1e-12)
    for run, n in (("lut64800", 64800), ("lut64800_qc", 64800)):
        g = dvbs2_waterfall.graph_of(run)
        assert g.nvar == n and g.nchk == n // 2
    assert getattr(dvbs2_waterfall.graph_of("lut64800_qc"), "qc", None) is not None


@pytest.fixture(scope="module")
def dvbs2_graphs():
    """(JAX, port) graphs of the DVB-S2 alist as the alist has it."""
    return (JaxGraph.from_alist(dvbs2_waterfall.DVBS2_ALIST),
            TannerGraph.from_alist(dvbs2_waterfall.DVBS2_ALIST))


def test_stability_payload_equals_stored_and_jax(dvbs2_graphs):
    """dvbs2_lut's stability numbers on the real matrix: equal to the stored
    TPU-era file's and to the JAX get_lam2stable_lut's (rtol 1e-12)."""
    jg, pg = dvbs2_graphs
    got = dvbs2_waterfall.stability(pg)
    with open(os.path.join(WATERFALL, "dvbs2_N64800_lut_q4.json")) as f:
        stored = json.load(f)
    for key in ("lam2", "lam2_stable_at_1dB", "design_thr", "thr_sigma", "thr_snr_db"):
        np.testing.assert_allclose(got[key], stored[key], rtol=1e-12, atol=0, err_msg=key)
    ens = jg.empirical_ensemble()
    want = jax_lam2stable(float(jax_snr2sig(0.5, 1.0)), ens.chk_degree_dist_dense(), 16, 16)
    np.testing.assert_allclose(got["lam2_stable_at_1dB"], float(want), rtol=1e-12, atol=0)
    assert got["lam2"] > got["lam2_stable_at_1dB"]  # the stability-violating profile


def _graph_edges(g):
    """(dv_vec, the check of every VN-major edge) of a Tanner graph."""
    chk = np.empty(g.num_edges, np.int64)
    for d in g.cn_degrees:
        chk[g.cn_edge_idx[int(d)]] = g.cn_node_idx[int(d)][:, None]
    return np.asarray(g.dv_vec), chk


def _spec_or_refusal(build, codec, dtype, refusal):
    try:
        return build(codec, dtype=dtype)
    except refusal as e:
        return f"refused: {type(e).__name__}"


@pytest.mark.parametrize("name", ["dvbs2_N64800_lut_q4_codec.npz",
                                  "dvbs2_N64800_lut_q4_qc_codec.npz"])
def test_stored_codecs_load_as_in_jax(name):
    """The TPU-era codecs load in the port array for array as in the JAX
    LUTCodec.load, and their arithmetic specs are equal or refused alike."""
    path = os.path.join(WATERFALL, name)
    j, p = JaxCodec.load(path), LUTCodec.load(path)
    for a, b in zip(_graph_edges(j.graph), _graph_edges(p.graph)):
        np.testing.assert_array_equal(a, b)
    for key in ("max_iters", "Nq_Cha", "min_lut", "nchk_lin_indep", "initial_message_mode"):
        assert getattr(p, key) == getattr(j, key), key
    for key in ("Nq_Msg", "qb_Cha", "qb_Msg", "cha2msg_map", "reuse_vec", "pmf_cha_design"):
        np.testing.assert_array_equal(getattr(p, key), getattr(j, key), err_msg=key)
    for a, b in zip(p.pmf_chk2var_trace, j.pmf_chk2var_trace, strict=True):
        np.testing.assert_array_equal(a, b)
    with np.load(path) as z:
        stored = str(z["var_tree_string"])
    assert serialize_tree_array(p.var_trees) == stored
    assert p.chk_trees == [] and j.chk_trees == []
    for jb, pb in ((jax_arith_spec, build_arith_spec), (jax_prefix_spec, build_arith_prefix_spec)):
        for dt in (np.int16, np.float32):
            sj = _spec_or_refusal(jb, j, dt, JaxArithBuildError)
            sp = _spec_or_refusal(pb, p, dt, ArithBuildError)
            if isinstance(sj, str) or isinstance(sp, str):
                assert sj == sp, (jb.__name__, dt)
                continue
            assert sj.num_iters == sp.num_iters and sj.degrees == sp.degrees
            np.testing.assert_array_equal(sj.leaf_cha, sp.leaf_cha)
            for it in range(sj.num_iters):
                for tj, tp in zip(sj.var_trees[it], sp.var_trees[it], strict=True):
                    for oj, op in zip(tj.ops, tp.ops, strict=True):
                        assert oj.operands == op.operands
                        np.testing.assert_array_equal(oj.thresholds, op.thresholds)
                        np.testing.assert_array_equal(oj.levels, op.levels)


def test_stored_codec_decoder_class_equals_jax(monkeypatch):
    """The simulator's decoder for the stored thr-0.67 codec at B=2048 is the
    one the JAX package picks where its kernels run (a HybridLUTDecoder)."""
    from lut_ldpc_tpu.decoder.staged import make_staged_decoder as jax_staged

    from lut_ldpc_torch.decoder import make_staged_decoder

    path = os.path.join(WATERFALL, "dvbs2_N64800_lut_q4_codec.npz")
    got = make_staged_decoder(LUTCodec.load(path), "cpu", max_batch=dvbs2_waterfall.BATCH)
    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    want = jax_staged(JaxCodec.load(path), early_exit=True, max_batch=dvbs2_waterfall.BATCH)
    assert type(got).__name__ == type(want).__name__ == "HybridLUTDecoder"


def _jax_loop(seg):
    """The loop a JAX ArithLUTDecoder segment runs (where its kernels run):
    "qc" (_build_qc_pallas), "std" (_build_std_kernels) or "blocks" (the XLA
    _build, the port's block loop); the phantom guards of
    arith_decoder.py:881 and :1116."""
    phantoms_ok = not any(p["td"] != 1 for p in seg._ph)
    if seg._use_qc_kernels() and phantoms_ok:
        return "qc"
    if seg._use_std_kernels() and phantoms_ok:
        return "std"
    return "blocks"


def _segments(dec):
    return [s for s in (getattr(dec, "pre", None), getattr(dec, "mid", None),
                        getattr(dec, "fin", None)) if s is not None] or [dec]


@pytest.mark.parametrize("run", ["dvbs2_lut", "dvbs2_lut_qc"])
def test_stored_codecs_pick_the_jax_loop(run, monkeypatch):
    """BERSim on each stored thr-0.67 codec with the run's graph (the alist's
    realization; for dvbs2_lut_qc the Z=360 one of load_periodic_alist) at
    B=2048: the port's decoder class and the loop of every segment equal the
    JAX BERSim's where its kernels run.  A codec file keeps no QC structure,
    so both take the std loop."""
    from lut_ldpc_torch.sim import BERSim, BERSimConfig, LDPCConfig, SimConfig

    qc_tag = "_qc" if run == "dvbs2_lut_qc" else ""
    path = os.path.join(WATERFALL, f"dvbs2_N64800_lut_q4{qc_tag}_codec.npz")
    if qc_tag:
        pgraph = dvbs2_waterfall.graph_of(run)
        jgraph = jax_dvbs2.load_periodic_alist(dvbs2_waterfall.DVBS2_ALIST)[0]
        assert pgraph.qc is not None and len(pgraph.phantoms) == 1
    else:
        jgraph = JaxGraph.from_alist(dvbs2_waterfall.DVBS2_ALIST)
        pgraph = TannerGraph.from_alist(dvbs2_waterfall.DVBS2_ALIST)
    snr, batch = np.array([1.6]), dvbs2_waterfall.BATCH
    cfg = BERSimConfig(sim=SimConfig(SNRdB=snr, Nframes=batch, batch_size=batch),
                       ldpc=LDPCConfig(zero_codeword=True))
    got = BERSim(cfg, pgraph, "cpu", codec=LUTCodec.load(path)).decoder
    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    want = jsim.BERSim(_jax_cfg(snr, batch, batch), jgraph, codec=JaxCodec.load(path)).decoder
    assert type(got).__name__ == type(want).__name__ == "HybridLUTDecoder"
    loops = [s.loop for s in _segments(got)]
    assert loops == [_jax_loop(s) for s in _segments(want)] == ["std", "std"]


# -- dvbs2_qc_equivalence -----------------------------------------------------
@pytest.fixture(scope="module")
def toy_alist(tmp_path_factory):
    cols = [np.array(sorted((x + t * Q) % M for x in g)) for g in GROUPS for t in range(Z)]
    cols += [np.array([j] if j == M - 1 else [j, j + 1]) for j in range(M)]
    H = np.zeros((M, len(cols)), np.uint8)
    for v, c in enumerate(cols):
        H[c, v] = 1
    path = str(tmp_path_factory.mktemp("toy") / "toy.alist")
    write_alist(path, H)
    return path


def _realizations(path):
    """{name: (JAX graph, port graph)} of the two realizations."""
    return {"qc": (jax_dvbs2.load_periodic_alist(path, Z)[0],
                   dvbs2.load_periodic_alist(path, Z)[0]),
            "gather": (JaxGraph.from_alist(path), TannerGraph.from_alist(path))}


@pytest.mark.parametrize("realization", ["qc", "gather"])
def test_equivalence_run_equals_jax(toy_alist, realization, monkeypatch):
    """run() on each realization of the toy matrix: the counters equal to
    the JAX script's run() under the JAX stream, and the decoder class the
    one the JAX package picks where its kernels run."""
    jex = _jax_example("dvbs2_qc_equivalence")
    jg, pg = _realizations(toy_alist)[realization]
    snrs, frames, batch, thr = [1.0, 2.0], 128, 64, 0.9
    want, _ = jex.run(jg, snrs, frames, batch, thr)
    # k of the design run() makes (the JAX codec of the same graph and sigma)
    jcodec = JaxCodec.design(jg, thr**2, max_iters=50, Nq_Cha=16, Nq_Msg=16)
    hook = jax_stream(_jax_cfg(snrs, frames, batch), jcodec.k, jg.nvar, None, 0)
    got, _, sim = dvbs2_qc_equivalence.run(pg, snrs, frames, batch, thr, device="cpu",
                                           channel=hook)
    _same_results(got, want)
    assert got.frame_errors.sum() > 0
    assert bool(pg.phantoms) == (realization == "qc")
    # the JAX choice where its kernels run (interpret mode stands for the TPU)
    from lut_ldpc_tpu.decoder.staged import make_staged_decoder as jax_staged

    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    jdec = jax_staged(jcodec, early_exit=True, max_batch=batch)
    assert type(sim.decoder).__name__ == type(jdec).__name__
    assert type(getattr(sim.decoder, "inner", sim.decoder)).__name__ == type(
        getattr(jdec, "inner", jdec)).__name__


@pytest.mark.parametrize("name", ["dvbs2_qc_equivalence.json",
                                  "dvbs2_qc_equivalence_hisnr.json"])
def test_fer_z_scores_reproduce_stored(name):
    with open(os.path.join(WATERFALL, name)) as f:
        stored = json.load(f)
    got = dvbs2_qc_equivalence.fer_z_scores(stored["qc"]["frame_errors"],
                                            stored["gather"]["frame_errors"],
                                            stored["frames"])
    assert got == stored["fer_z_scores"]


def test_equivalence_payload_keys():
    with open(os.path.join(WATERFALL, "dvbs2_qc_equivalence.json")) as f:
        stored = json.load(f)
    r = BERSimResults(snr_db=np.array([1.0]), nvar=4, nchk=2, rate=0.5)
    r.add_counts(0, 8, 16, 32, 1, 2, 3, 40)
    got = dvbs2_qc_equivalence.payload_of([1.0], 8, 0.9, r, 1.0, r, 2.0)
    assert sorted(got) == sorted(stored)
    assert sorted(got["qc"]) == sorted(stored["qc"]) == sorted(got["gather"])
    assert got["fer_z_scores"] == [0.0] and got["qc"]["frame_errors"] == [1]


# -- ber_waterfall ------------------------------------------------------------
def test_ber_waterfall_files_and_counters(tmp_path):
    """The CLI at a tiny size writes the names of docs/waterfall/; under the
    JAX stream its min-LUT and nms runs equal the JAX script's."""
    out = str(tmp_path / "cli")
    args = ["--frames", "64", "--batch", "64", "--snr", "2.0"]
    assert ber_waterfall.main(args + ["--device", "cpu", "--out", out]) == 0
    names = {"lut_q4.npz", "lut_q4.json", "lut_q4.it", "spa.npz", "spa.json", "nms.npz",
             "nms.json"}
    got_names = set(os.listdir(out))
    assert names <= got_names <= names | {"waterfall.png"}
    assert names <= set(os.listdir(WATERFALL))

    jex = _jax_example("ber_waterfall")
    jdir = str(tmp_path / "jax")
    argv = sys.argv
    sys.argv = ["ber_waterfall.py", *args, "--out", jdir, "--cpu"]
    try:
        jex.main()
    finally:
        sys.argv = argv
    H = TannerGraph.from_alist(ber_waterfall.ALIST).to_dense()
    k = H.shape[1] - gf2_rank(H)  # the codec's k (zero codeword: all-zero data bits)
    hook = jax_stream(_jax_cfg([2.0], 64, 64), k, H.shape[1], None, 0)
    runs = ber_waterfall.run_waterfall(str(tmp_path / "hook"), 64, 64, "2.0", "cpu",
                                       channel=hook)
    assert [r[0] for r in runs] == ["lut_q4", "spa", "nms"]
    for name in ("lut_q4", "nms"):
        _same_results(_load(str(tmp_path / "hook" / f"{name}.npz")),
                      _load(os.path.join(jdir, f"{name}.npz")))


# -- make_assets, render_tree_example -----------------------------------------
def test_make_assets_reproduces_the_repo(tmp_path):
    """ensembles/, the four PEG codes written without --big, the two QC
    structures and trees/example.tikz: byte for byte the repo's."""
    out = str(tmp_path / "assets")
    assert make_assets.main(["--out", out]) == 0
    ens = sorted(os.listdir(os.path.join(REPO, "ensembles")))
    assert sorted(os.listdir(os.path.join(out, "ensembles"))) == ens
    files = [os.path.join("ensembles", n) for n in ens] + [
        os.path.join("codes", n) for n in (
            "rate0.50_dv03_dc06_N1000.alist", "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist",
            "rate0.84_reg_v6c32_N2048.alist", "rate0.50_dv02-17_dc08-09_lut_q4_N1000.alist",
            "rate0.50_dv03_dc06_N10000_qc.qc.json",
            "rate0.50_dv02-17_dc08-09_N64800_qc.qc.json")] + [
        os.path.join("trees", "example.tikz")]
    for rel in files:
        with open(os.path.join(out, rel), "rb") as a, open(os.path.join(REPO, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert len(os.listdir(os.path.join(out, "codes"))) == 6  # no DVB-S2 import without --reference


def test_render_tree_example_tikz(tmp_path):
    written = render_tree_example.render(str(tmp_path))
    with open(written[0]) as a, open(os.path.join(REPO, "trees", "example.tikz")) as b:
        assert a.read() == b.read()
    assert [os.path.basename(p) for p in written][:1] == ["example.tikz"]


@pytest.mark.parametrize("module", [dvbs2_waterfall, dvbs2_qc_equivalence, ber_waterfall],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_cuda_without_a_card_raises(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        module.main(["--device", "cuda", "--out", str(tmp_path)])
    assert os.listdir(tmp_path) == []
