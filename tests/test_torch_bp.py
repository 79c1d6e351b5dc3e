"""The port's float BP baselines (lut_ldpc_torch/decoder/bp.py) against the
JAX package's (lut_ldpc_tpu/decoder/bp.py) on the CPU.

Graphs: the N=96 random (3,6) code of tests/util_codes.py, and for the
exact algorithms also the N=500 irregular code
codes/rate0.50_dv02-17_dc08-09_lut_q4_N500.alist (variable degrees 2-17:
the slot sum's order at every degree; minsum, nms and oms at 10
iterations); at most 15 iterations; inputs:
seeded numpy LLRs of noisy all-zero frames at 2-3.5 dB.

Tolerances: minsum, nms, oms and qllr (with its logexp table and without)
are exact: bits, ok and iters equal, with early exit on and off.  spa goes
through log and tanh, which differ between XLA's and torch's math
libraries: its one-iteration posteriors agree within rtol 1e-5 / atol 1e-5
(where XLA's own float32 value does, see test_spa_within_tolerance), and ok
and iters agree on at least 95 % of 64 frames.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lut_ldpc_tpu.core.tanner import TannerGraph as JaxGraph
from lut_ldpc_tpu.decoder import bp as jbp
from lut_ldpc_tpu.sim.config import BPConfig as JaxBPConfig

from lut_ldpc_torch.core.tanner import TannerGraph
from lut_ldpc_torch.decoder import bp
from lut_ldpc_torch.sim.config import BPConfig

from util_codes import random_regular_H

ALGS = [("minsum", {}), ("nms", {}), ("oms", {}), ("qllr", {}),
        ("qllr", {"qllr_table_size": 0})]


IRREGULAR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "codes", "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist")


@functools.lru_cache(maxsize=None)
def _graphs(code):
    """(JAX graph, port graph) of "regular" (N=96 (3,6)) or "irregular"
    (N=500, variable degrees 2-17)."""
    if code == "irregular":
        return JaxGraph.from_alist(IRREGULAR), TannerGraph.from_alist(IRREGULAR)
    H = random_regular_H(96, 3, 6, seed=1)
    return JaxGraph.from_dense(H), TannerGraph.from_dense(H)


@pytest.fixture(scope="module")
def graphs():
    return _graphs("regular")


def _llr(nvar, B, snr_db, seed):
    rng = np.random.default_rng(seed)
    sig = float(10 ** (-snr_db / 20) / np.sqrt(2 * 0.5))
    y = 1.0 + sig * rng.standard_normal((B, nvar))
    return (2.0 * y / sig**2).astype(np.float32)


def _llrs(nvar):
    """64 frames: 16 each at 2, 2.5, 3 and 3.5 dB."""
    return np.concatenate([_llr(nvar, 16, s, 10 + i)
                           for i, s in enumerate((2.0, 2.5, 3.0, 3.5))])


ALG_IDS = ["minsum", "nms", "oms", "qllr", "qllr_notable"]
# the irregular code takes the float algorithms only, at 10 iterations:
# qllr's slot sum is int32 and so exact in any order, and its JAX decoder
# takes 25-85 s to compile at that size
EXACT_CASES = [pytest.param("regular", alg, kw, 15, id=f"{i}-regular")
               for (alg, kw), i in zip(ALGS, ALG_IDS)] + [
    pytest.param("irregular", alg, kw, 10, id=f"{i}-irregular")
    for (alg, kw), i in zip(ALGS, ALG_IDS) if alg != "qllr"]


@pytest.mark.parametrize("early_exit", [True, False], ids=["early", "full"])
@pytest.mark.parametrize("code,alg,kw,iters", EXACT_CASES)
def test_exact_algorithms_equal_jax(code, alg, kw, iters, early_exit):
    jg, tg = _graphs(code)
    llr = _llrs(jg.nvar)
    want = jbp.BPDecoder(jg, max_iters=iters, algorithm=alg, early_exit=early_exit,
                         **kw)(llr)
    got = bp.BPDecoder(tg, "cpu", max_iters=iters, algorithm=alg, early_exit=early_exit,
                       **kw)(llr)
    for w, g, name in zip(want, got, ("bits", "ok", "iters")):
        assert np.array_equal(np.asarray(w), g.numpy()), name
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.int32
    if early_exit:  # frames converge at different iterations: the latch works
        assert len(np.unique(got[2].numpy())) > 2


def _one_iteration_post(g, llr, cn_update, xp):
    """Posteriors after one iteration of bp.py:163-181 with `cn_update` on
    the graph's index arrays, in array module `xp` (jax.numpy or numpy)."""
    llr = xp.asarray(llr)
    msgs = llr[:, g.var_llr_edge_expand()]
    for d in g.cn_degrees:
        idx = g.cn_edge_idx[int(d)]
        if xp is np:
            msgs[:, idx] = cn_update(msgs[:, idx])
        else:
            msgs = msgs.at[:, idx].set(cn_update(msgs[:, idx]))
    post = [None] * g.nvar
    for d in g.vn_degrees:
        total = llr[:, g.vn_node_idx[int(d)]] + xp.sum(msgs[:, g.vn_edge_idx[int(d)]], axis=-1)
        for j, v in enumerate(g.vn_node_idx[int(d)]):
            post[v] = total[:, j]
    return np.stack([np.asarray(p) for p in post], axis=1)


def _spa_cn_f64(m):
    """The spa CN update of bp.py:135-146 in float64."""
    sgn = np.where(m < 0, -1.0, 1.0)
    p = -np.log(np.tanh(0.5 * np.clip(np.abs(m), 1e-7, 30.0)))
    x = np.clip(p.sum(axis=-1, keepdims=True) - p, 1e-7, 30.0)
    return np.prod(sgn, axis=-1, keepdims=True) * sgn * -np.log(np.tanh(0.5 * x))


def test_spa_within_tolerance(graphs):
    """One-iteration posteriors within rtol 1e-5 / atol 1e-5 of the JAX
    decoder's wherever the JAX float32 value itself lies within that
    tolerance of the float64 evaluation of the same update; elsewhere (XLA's
    own log / tanh error: 1 element of 6144 here, 1.1e-5 relative) the port
    must be the closer of the two to float64.  Then ok and iters of the full
    decode equal on at least 95 % of the frames."""
    jg, tg = graphs
    # the first torch.tanh call of a process on the CPU was seen to differ
    # from later ones in the last bit now and then; the posteriors here are
    # ill-conditioned enough (phi near its clip) to show it, so compare
    # the steady state
    torch.tanh(torch.ones(1))
    llr = _llrs(jg.nvar)
    jdec = jbp.BPDecoder(jg, max_iters=15, algorithm="spa")
    tdec = bp.BPDecoder(tg, "cpu", max_iters=15, algorithm="spa")
    lt = torch.as_tensor(llr).t().contiguous()
    _, post = tdec._vn_pass(tdec._cn_pass(lt[tdec._edge_var]), lt)
    got = post.t().numpy()
    want = _one_iteration_post(jg, llr, jdec._cn_update, jnp)
    exact = _one_iteration_post(jg, llr.astype(np.float64), _spa_cn_f64, np)

    def close(a, b):
        return np.abs(a - b) <= 1e-5 + 1e-5 * np.abs(b)

    sure = close(want, exact)
    assert sure.mean() >= 0.99
    np.testing.assert_allclose(got[sure], want[sure], rtol=1e-5, atol=1e-5)
    assert close(got, exact).all()
    assert (np.abs(got - exact) <= np.abs(want - exact))[~sure].all()
    want = jdec(llr)
    got = tdec(llr)
    ok_eq = np.asarray(want[1]) == got[1].numpy()
    it_eq = np.asarray(want[2]) == got[2].numpy()
    assert ok_eq.mean() >= 0.95 and it_eq.mean() >= 0.95
    assert np.asarray(got[1]).mean() > 0.5  # the decoder works at all


def test_phantom_graph_raises():
    import dataclasses

    from lut_ldpc_torch.core import qc

    st = qc.qc_generate_regular(3, 6, Z=16, nb=8, seed=1)
    i = int(np.nonzero(st.base[:, 0] >= 0)[0][0])
    st = dataclasses.replace(st, phantoms=((0, 3, i, (3 + int(st.base[i, 0])) % 16),))
    with pytest.raises(ValueError, match="phantom"):
        bp.BPDecoder(qc.qc_expand(st), "cpu")
    with pytest.raises(ValueError, match="unknown BP algorithm"):
        bp.BPDecoder(qc.qc_expand(qc.qc_generate_regular(3, 6, Z=16, nb=8, seed=1)),
                     "cpu", algorithm="bogus")


@pytest.mark.parametrize("cfg", [
    dict(max_iter=12, qllr_total_bits=16, qllr_frac_bits=8),
    dict(max_iter=20, qllr_total_bits=28, qllr_table_size=300),
    dict(max_iter=7, algorithm="oms", offset=0.25),
    dict(max_iter=9, algorithm="nms", scale=0.625),
], ids=["qllr16", "qllr28", "oms", "nms"])
def test_make_bp_decoder_maps_config_as_jax(graphs, cfg):
    jg, tg = graphs
    want = jbp.make_bp_decoder(jg, JaxBPConfig(**cfg), early_exit=False)
    got = bp.make_bp_decoder(tg, BPConfig(**cfg), "cpu", early_exit=False)
    for name in ("algorithm", "max_iters", "scale", "offset", "early_exit", "llr_clip"):
        assert getattr(got, name) == getattr(want, name), name
    if want.algorithm == "qllr":
        for name in ("q_scale", "q_shift", "q_max"):
            assert getattr(got, name) == getattr(want, name), name
        if want._q_table is None:
            assert got._q_table is None
        else:
            assert np.array_equal(np.asarray(want._q_table), got._q_table.numpy())


def test_boxplus_phi_equal_jax():
    """Within 1e-6 relative of the JAX phi where phi loses no digits (x up to
    2.5, phi above 0.15).  Above that, -log(tanh(x/2)) is the distance of
    tanh from 1 in float32, quantized by tanh's rounding unit there (2^-24):
    one ulp of tanh apart is 6e-8 apart in phi, any relative amount (JAX and
    torch differ by 1e-6 relative at x=2.9 and by 100 % at x=16).  There
    both stay within two such units (2.4e-7) of each other and of the
    float64 value."""
    x = np.concatenate([np.geomspace(1e-9, 40.0, 400), [0.0, 1e-7, 30.0, 50.0]])
    x = x.astype(np.float32)
    want = np.asarray(jbp.boxplus_phi(jnp.asarray(x)))
    got = bp.boxplus_phi(torch.as_tensor(x)).numpy()
    exact = -np.log(np.tanh(0.5 * np.clip(x.astype(np.float64), 1e-7, 30.0)))
    lo = x <= 2.5
    np.testing.assert_allclose(got[lo], want[lo], rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2.4e-7)
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=2.4e-7)
