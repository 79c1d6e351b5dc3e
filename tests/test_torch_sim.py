"""The port's Monte-Carlo simulator (lut_ldpc_torch/sim, cli/ber_sim.py)
against the JAX package's (lut_ldpc_tpu/sim, cli/ber_sim.py) on the CPU.

torch's random streams are not threefry's, so the simulators are held
equal through the ``channel=`` hook: it feeds the port exactly the stream
the JAX simulator draws (ber_sim.py:181-197: fold_in -> split ->
bernoulli, bpsk_awgn_llr), and the seven counters must then be equal per
SNR point, for the LUT decoders (zero and encoded codewords, cont and qcha
initial messages), the BP baseline, an Nfers stop in the middle of a point
and a ber_min skip.  Everything else is exact too: the channel ops on the
same y and sigma, the quantizer against jnp.searchsorted over float32
boundaries, INI parsing, the designed codec, results files read across
both packages, and the CLI's file names.  Codecs cross as files
(tests/torch_carry.py).  Graph: the N=96 random (3,6) code of
tests/util_codes.py, a few iterations.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lut_ldpc_tpu.cli.ber_sim import gen_filename as jax_gen_filename
from lut_ldpc_tpu.core.alist import write_alist
from lut_ldpc_tpu.core.tanner import TannerGraph as JaxGraph
from lut_ldpc_tpu.decoder import LUTCodec as JaxCodec
from lut_ldpc_tpu.decoder.bp import BPDecoder as JaxBP
from lut_ldpc_tpu import sim as jsim
from lut_ldpc_tpu.sim import channel as jchannel
from lut_ldpc_tpu.sim.ber_sim import run_from_config as jax_run_from_config

from lut_ldpc_torch import sim as tsim
from lut_ldpc_torch.cli import ber_sim as tcli
from lut_ldpc_torch.core.tanner import TannerGraph
from lut_ldpc_torch.decoder.bp import BPDecoder
from lut_ldpc_torch.ops.pmf import snr2sig
from lut_ldpc_torch.sim import channel as tchannel
from lut_ldpc_torch.sim.ber_sim import run_from_config

from torch_carry import carry, jax_stream
from util_codes import random_regular_H

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("frames", "data_bits", "uncoded_bits", "frame_errors",
            "data_bit_errors", "uncoded_bit_errors", "decode_iters")


@pytest.fixture(scope="module")
def codecs(tmp_path_factory):
    """(JAX codec, port codec) pairs carried as files: 'zero' (no
    generator) and 'cont' / 'qcha' (systematic generator, column-permuted
    graph)."""
    d = tmp_path_factory.mktemp("codecs")
    sig = float(snr2sig(0.5, 2.0))
    H = random_regular_H(96, 3, 6, seed=1)
    zero = JaxCodec.design(JaxGraph.from_dense(H), sig**2, max_iters=6)
    enc = JaxCodec.design(JaxGraph.from_dense(H), sig**2, max_iters=6,
                          build_generator=True)
    out = {"zero": carry(zero, d / "zero.npz"), "cont": carry(enc, d / "cont.npz")}
    enc.initial_message_mode = "qcha"
    out["qcha"] = carry(enc, d / "qcha.npz")
    return out


def _cfgs(snrs, nframes=128, batch=64, nfers=10**9, zero=True, **sim_kw):
    """The same configuration for both packages: (JAX config, port config)."""
    def make(m):
        return m.BERSimConfig(
            sim=m.SimConfig(SNRdB=np.asarray(snrs, dtype=float), Nframes=nframes,
                            Nfers=nfers, batch_size=batch, **sim_kw),
            ldpc=m.LDPCConfig(zero_codeword=zero))
    return make(jsim), make(tsim)


def _equal_counters(want, got):
    for name in COUNTERS:
        assert getattr(got, name).tolist() == getattr(want, name).tolist(), name
    assert got.nvar == want.nvar and got.nchk == want.nchk and got.rate == want.rate


CASES = {
    "lut_zero": dict(codec="zero", snrs=[2.0, 3.0]),
    "lut_encoded_cont": dict(codec="cont", snrs=[3.0, 4.0], zero=False),
    "lut_encoded_qcha": dict(codec="qcha", snrs=[3.0], zero=False),
    "bp_nms_encoded": dict(codec="cont", bp="nms", snrs=[2.5, 3.5], zero=False),
    "nfers_stop": dict(codec="zero", snrs=[1.0, 1.5], nframes=512, batch=32, nfers=4),
    "ber_min_skip": dict(codec="zero", snrs=[3.0, 4.0, 5.0], ber_min=1e-2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_counters_equal_jax_under_hook(codecs, case):
    c = dict(CASES[case])
    jcodec, tcodec = codecs[c.pop("codec")]
    alg = c.pop("bp", None)
    jcfg, tcfg = _cfgs(c.pop("snrs"), **c)
    seed = 3
    gen_T = None if jcfg.ldpc.zero_codeword else jcodec.gen_T
    if alg:
        jg, tg = jcodec.graph, tcodec.graph
        jax_sim = jsim.BERSim(jcfg, jg, bp_decoder=JaxBP(jg, 8, algorithm=alg), gen_T=gen_T)
        port = tsim.BERSim(tcfg, tg, "cpu", bp_decoder=BPDecoder(tg, "cpu", 8, algorithm=alg),
                           gen_T=gen_T, channel=jax_stream(jcfg, jax_sim.k, jg.nvar,
                                                           gen_T, seed))
    else:
        jax_sim = jsim.BERSim(jcfg, jcodec.graph, codec=jcodec)
        port = tsim.BERSim(tcfg, tcodec.graph, "cpu", codec=tcodec,
                           channel=jax_stream(jcfg, jax_sim.k, jcodec.nvar, gen_T, seed))
    want = jax_sim.run(seed=seed, verbose=False)
    got = port.run(seed=seed, verbose=False)
    _equal_counters(want, got)
    assert got.frame_errors.sum() > 0 and got.frames[0] > 0
    if case == "nfers_stop":
        assert 0 < got.frames[0] < 512  # stopped by Nfers inside the point
    if case == "ber_min_skip":
        assert got.frames[-1] == 0  # zero-padded after the skip


def test_channel_ops_equal_jax():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (8, 333)).astype(np.uint8)
    y = (1.0 + 0.83 * rng.standard_normal((8, 333))).astype(np.float32)
    for sigma in (0.8317, 0.7079457843841379, 1.1):
        want = np.asarray(jax.jit(jchannel.llr_from_rx)(jnp.asarray(y), sigma))
        got = tchannel.llr_from_rx(torch.as_tensor(y), torch.tensor(sigma, dtype=torch.float32))
        assert np.array_equal(want, got.numpy())
        assert np.array_equal(np.asarray(jchannel.llr_from_rx(jnp.asarray(y), np.float32(sigma))),
                               got.numpy())
    assert np.array_equal(np.asarray(jchannel.bpsk_modulate(jnp.asarray(bits))),
                          tchannel.bpsk_modulate(torch.as_tensor(bits)).numpy())
    # the port's own draw: float32 output of the codeword's shape
    gen = torch.Generator().manual_seed(1)
    llr, yy = tchannel.bpsk_awgn_llr(gen, torch.as_tensor(bits),
                                     torch.tensor(0.8, dtype=torch.float32))
    assert llr.dtype == yy.dtype == torch.float32 and llr.shape == bits.shape
    assert torch.equal(llr, tchannel.llr_from_rx(yy, torch.tensor(0.8, dtype=torch.float32)))


@pytest.mark.parametrize("mode", ["cont", "qcha"])
def test_quantize_equals_jnp_searchsorted(codecs, mode):
    jcodec, tcodec = codecs[mode]
    cfg = _cfgs([2.0], zero=False)[1]
    port = tsim.BERSim(cfg, tcodec.graph, "cpu", codec=tcodec)
    rng = np.random.default_rng(4)
    llr = (rng.standard_normal((16, 96)) * 8).astype(np.float32)
    # every float32 boundary and its neighbours: the side="left" ties; the
    # neighbours of a 0.0 boundary are denormal, where XLA on the CPU
    # flushes to zero and torch does not (asserted below): the smallest
    # normal float32 stands beside 0.0 instead
    qb = np.asarray(jnp.asarray(jcodec.qb_Cha))
    up, down = np.nextafter(qb, np.inf), np.nextafter(qb, -np.inf)
    tiny = np.finfo(np.float32).tiny
    up[qb == 0], down[qb == 0] = tiny, -tiny
    edge = np.concatenate([qb, up, down])
    llr[0, : edge.size] = edge
    lc, lm = port.quantize(torch.as_tensor(llr))
    want_c = jnp.searchsorted(jnp.asarray(jcodec.qb_Cha), jnp.asarray(llr), side="left")
    if mode == "qcha":
        want_m = jnp.asarray(jcodec.cha2msg_map, dtype=jnp.int32)[want_c]
    else:
        want_m = jnp.searchsorted(jnp.asarray(jcodec.qb_Msg), jnp.asarray(llr), side="left")
    assert lc.dtype == lm.dtype == torch.int32
    assert np.array_equal(np.asarray(want_c), lc.numpy())
    assert np.array_equal(np.asarray(want_m), lm.numpy())
    # the one difference: a denormal LLR just above a 0.0 boundary is 0.0
    # to XLA on the CPU (left of it) and above it to the port (IEEE)
    den = np.array([np.nextafter(np.float32(0), np.float32(1))], np.float32)
    zero_at = int(np.searchsorted(qb, 0.0, side="left"))
    assert qb[zero_at] == 0.0
    assert int(jnp.searchsorted(jnp.asarray(jcodec.qb_Cha), jnp.asarray(den))[0]) == zero_at
    assert int(port.quantize(torch.as_tensor(den[None]))[0][0, 0]) == zero_at + 1


def test_port_draws_deterministic(codecs):
    _, tcodec = codecs["cont"]
    cfg = _cfgs([2.5], nframes=128, zero=False)[1]
    runs = [tsim.BERSim(cfg, tcodec.graph, "cpu", codec=tcodec).run(seed=s, verbose=False)
            for s in (7, 7, 8)]
    for name in COUNTERS:
        assert getattr(runs[0], name).tolist() == getattr(runs[1], name).tolist()
    assert runs[0].uncoded_bit_errors.tolist() != runs[2].uncoded_bit_errors.tolist()
    assert 0 < runs[0].ber()[0] < runs[0].uncoded_ber()[0]


def _rewind(ckpt, keep_point0, sim=None, seed=None, n_batches=0):
    """Rewrite a finished checkpoint as if interrupted: point 1 zeroed, and
    point 0 kept or refilled with its first n_batches batches."""
    r = tsim.BERSimResults.load(ckpt)
    for name in COUNTERS:
        arr = getattr(r, name)
        arr[1] = 0
        if not keep_point0:
            arr[0] = 0
    if not keep_point0:
        sigma = torch.tensor(float(snr2sig(sim.rate, 2.0)), dtype=torch.float32)
        for bb in range(n_batches):
            c = sim.step(seed, 0, bb, sigma)
            r.add_counts(0, *(c[name] for name in COUNTERS))
    r.save(ckpt.removesuffix(".npz"))
    with open(ckpt + ".state", "w") as f:
        json.dump({"ss": 0 if not keep_point0 else 1, "bb": n_batches}, f)


@pytest.mark.parametrize("where", ["point", "mid_point"])
def test_checkpoint_resume(tmp_path, codecs, where):
    """Mirrors tests/test_checkpoint.py: a rewound checkpoint, at the start
    of SNR point 1 or after batch 2 of point 0, resumes to the counters of
    an uninterrupted run."""
    _, tcodec = codecs["zero"]
    cfg = _cfgs([2.0, 3.0], nframes=192)[1]
    ckpt = str(tmp_path / "ck.npz")
    sim = tsim.BERSim(cfg, tcodec.graph, "cpu", codec=tcodec)
    full = sim.run(seed=5, verbose=False)
    sim.run(seed=5, verbose=False, checkpoint_path=ckpt, checkpoint_every=1)
    if where == "point":
        _rewind(ckpt, keep_point0=True)
    else:
        _rewind(ckpt, keep_point0=False, sim=sim, seed=5, n_batches=2)
    resumed = tsim.BERSim(cfg, tcodec.graph, "cpu", codec=tcodec).run(
        seed=5, verbose=False, checkpoint_path=ckpt)
    for name in COUNTERS:
        assert getattr(resumed, name).tolist() == getattr(full, name).tolist(), name


def _ini_files():
    d = os.path.join(REPO, "params")
    return sorted(f for f in os.listdir(d) if f.startswith("ber.ini."))


@pytest.mark.parametrize("name", _ini_files())
def test_parse_ini_equal_jax(name):
    path = os.path.join(REPO, "params", name)
    want, got = jsim.parse_ini(path), tsim.parse_ini(path)
    assert got.codec_type == want.codec_type
    for part in ("sim", "ldpc", "bp", "lut"):
        w, g = getattr(want, part), getattr(got, part)
        assert (w is None) == (g is None)
        if w is None:
            continue
        for key, val in vars(w).items():
            assert np.array_equal(np.asarray(getattr(g, key)), np.asarray(val)), (part, key)


def _small_ini(tmp_path, body):
    (tmp_path / "codes").mkdir(exist_ok=True)
    write_alist(str(tmp_path / "codes" / "c96.alist"), random_regular_H(96, 3, 6, seed=1))
    ini = tmp_path / "ber.ini"
    ini.write_text("[Sim]\nSNRdB = 3\nNframes = 16\nNfers = 1000\nbatch_size = 16\n"
                   "results_dir = results\n\n" + body)
    return str(ini)


def test_run_from_config_designs_as_jax(tmp_path):
    """The LUT branch (qc_detect on a graph without the structure,
    qbits_messages, encoded: generator cache, column permutation) and the
    encoded BP branch build what the JAX run_from_config builds."""
    ini = _small_ini(tmp_path, "[LDPC]\nparity_filename = c96\nzero_codeword = 0\n"
                     "qc_detect = 1\n\n"  # no 360-periodic structure: the plain graph
                     "[LUT]\nmax_iter = 4\ndesign_thr = 0.88\nqbits_channel = 4\n"
                     "qbits_messages = 4 4 3 3\ninitial_message_mode = qcha\n")
    _, jsim_ = jax_run_from_config(jsim.parse_ini(ini), codes_root=str(tmp_path),
                                   verbose=False)
    res, tsim_ = run_from_config(tsim.parse_ini(ini), "cpu", codes_root=str(tmp_path),
                                 verbose=False)
    jc, tc = jsim_.codec, tsim_.codec
    for name in ("Nq_Msg", "qb_Cha", "qb_Msg", "cha2msg_map", "gen_perm", "gen_T"):
        assert np.array_equal(np.asarray(getattr(jc, name)), np.asarray(getattr(tc, name))), name
    assert tc.initial_message_mode == jc.initial_message_mode == "qcha"
    assert np.array_equal(tc.graph.to_dense(), jc.graph.to_dense())
    assert res.frames.tolist() == [16] and tsim_.k == jsim_.k
    assert os.path.exists(tmp_path / "codes" / "c96.gen.npz")

    ini = _small_ini(tmp_path, "[LDPC]\nparity_filename = c96\nzero_codeword = 0\n\n"
                     "[BP]\nmax_iter = 10\nalgorithm = oms\n")
    _, jsim_ = jax_run_from_config(jsim.parse_ini(ini), codes_root=str(tmp_path),
                                   verbose=False)
    _, tsim_ = run_from_config(tsim.parse_ini(ini), "cpu", codes_root=str(tmp_path),
                               verbose=False)
    assert np.array_equal(tsim_.graph.to_dense(), jsim_.graph.to_dense())
    assert np.array_equal(np.asarray(tsim_.gen_T), np.asarray(jsim_.gen_T))
    assert tsim_.decoder.algorithm == "oms" and tsim_.decoder.max_iters == 10


def test_results_files_cross_both_ways(tmp_path, codecs):
    jcodec, tcodec = codecs["zero"]
    jcfg, tcfg = _cfgs([2.0, 3.0], nframes=64)
    port = tsim.BERSim(tcfg, tcodec.graph, "cpu", codec=tcodec).run(seed=0, verbose=False)
    jax_r = jsim.BERSim(jcfg, jcodec.graph, codec=jcodec).run(seed=0, verbose=False)
    port.save(str(tmp_path / "port.npz"))
    port.save_itfile(str(tmp_path / "port.it"))
    jax_r.save(str(tmp_path / "jax.npz"))
    jax_r.save_itfile(str(tmp_path / "jax.it"))
    for who, want in (("port", port), ("jax", jax_r)):
        for load in (jsim.BERSimResults.load, tsim.BERSimResults.load):
            _equal_counters(want, load(str(tmp_path / f"{who}.npz")))
        for load in (jsim.BERSimResults.load_itfile, tsim.BERSimResults.load_itfile):
            r = load(str(tmp_path / f"{who}.it"))
            for name in ("frames", "data_bits", "frame_errors", "data_bit_errors",
                         "uncoded_bit_errors"):
                assert getattr(r, name).tolist() == getattr(want, name).tolist(), name
            assert r.rate == want.rate and r.snr_db.tolist() == want.snr_db.tolist()
    paths = [str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")]
    for agg in (jsim.aggregate(paths), tsim.aggregate(paths)):
        assert agg.frames.tolist() == (port.frames + jax_r.frames).tolist()
        assert agg.data_bit_errors.tolist() == (
            port.data_bit_errors + jax_r.data_bit_errors).tolist()
    with open(tmp_path / "port.json") as f:
        assert json.load(f)["frames"] == port.frames.tolist()


def test_cli_writes_jax_file_names(tmp_path, capsys):
    ini = _small_ini(tmp_path, "[LDPC]\nparity_filename = c96\nzero_codeword = 1\n\n"
                     "[BP]\nmax_iter = 10\nalgorithm = minsum\n")
    assert tcli.main(["-p", ini, "-s", "2", "-b", str(tmp_path), "-c", "_x",
                      "--device", "cpu"]) == 0
    assert "Done simulating" in capsys.readouterr().out
    cfg = jsim.parse_ini(ini)
    nvar, rate = 96, (96 - 48) / 96
    base = jax_gen_filename(cfg, nvar, rate, "_x")
    assert tcli.gen_filename(tsim.parse_ini(ini), nvar, rate, "_x") == base
    out = tmp_path / "results" / base
    stem = f"{base}_rseed0002"
    assert sorted(os.listdir(out)) == sorted(
        [f"{stem}.npz", f"{stem}.json", f"{stem}.it", "ber.ini"])
    r = jsim.BERSimResults.load(str(out / f"{stem}.npz"))
    assert r.frames.tolist() == [16] and r.nvar == nvar
    if not torch.cuda.is_available():  # no quiet fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["-p", ini, "-b", str(tmp_path)])


def test_profile_dir_writes_a_trace(tmp_path, codecs, monkeypatch):
    """LUT_PROFILE_DIR: the sweep runs under torch.profiler and leaves a
    Chrome trace there."""
    monkeypatch.setenv("LUT_PROFILE_DIR", str(tmp_path / "prof"))
    _, tcodec = codecs["zero"]
    tsim.BERSim(_cfgs([3.0], nframes=64)[1], tcodec.graph, "cpu", codec=tcodec).run(
        seed=0, verbose=False)
    with open(tmp_path / "prof" / "ber_sim_trace.json") as f:
        assert json.load(f)["traceEvents"]
