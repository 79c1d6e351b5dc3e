"""The port's regression ledger (lut_ldpc_torch/tools/perf_regress.py)
against the JAX package's (tools/perf_regress.py, loaded from its path).

On the CPU ``record`` refuses and writes nothing.  ``check`` is held to the
JAX tool's on synthetic ledgers: the same return code and the same line for
every metric both tools gate (tolerance zero: the lines are text).  The
measuring code is held where it runs here: the frames the three decodes draw
equal the JAX tool's draws (tools/perf_regress.py:155-159 and :177-186)
through the JAX ``quantize_channel``, and the fused CN -> VN chain on the
plain versions equals the JAX ``cn_qc_pass`` -> ``vn_qc_pass`` chain in
interpret mode on the regular (3,6) code of tests/test_torch_qc_kernels.py
at its B (tolerance zero on the real rows).
"""

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lut_ldpc_tpu.core.qc import qc_expand, qc_generate_regular
from lut_ldpc_tpu.decoder import LUTCodec as JaxCodec
from lut_ldpc_tpu.decoder.arith import build_arith_prefix_spec as jax_prefix_spec
from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder as JaxArith
from lut_ldpc_tpu.ops.pmf import snr2sig as jax_snr2sig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_qc_kernels import B, _pallas_cn, _pallas_vn  # noqa: E402
from torch_carry import carry  # noqa: E402

from lut_ldpc_torch.tools import perf_regress as pr  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}


def _jax_tool(ledger):
    """tools/perf_regress.py loaded from its path, its ledger pointed at
    `ledger`."""
    spec = importlib.util.spec_from_file_location(
        "jax_perf_regress", os.path.join(REPO, "tools", "perf_regress.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.LEDGER = str(ledger)
    return mod


def test_record_refuses_on_the_cpu(tmp_path, capsys):
    ledger = tmp_path / "kernels_torch.json"
    for argv in (["record", "--ledger", str(ledger)],
                 ["record", "--ledger", str(ledger), "--device", "cpu"]):
        assert pr.main(argv) == 1
        assert "refusing" in capsys.readouterr().out
    assert not ledger.exists()
    with pytest.raises((RuntimeError, ValueError)):
        pr.record("cpu")


def _rec(headline=100.0, dvbs2=500.0, peg=1000.0, compile_s=10.0, card=CARD, **extra):
    r = {"rev": "abc", "ts": 1.0, "device": dict(card), "n10000_fused_ms": 1.0,
         "headline_decode_ms": headline, "dvbs2_decode_ms": dvbs2, "peg_decode_ms": peg,
         "compile_s": compile_s, **extra}
    return {k: v for k, v in r.items() if v is not None}


PRIOR = [_rec(101.0, 510.0, 990.0, 9.0), _rec(100.0, 500.0, 1000.0, 10.0),
         _rec(104.0, 505.0, 1010.0, 12.0)]
LEDGERS = {
    "no ledger": None,
    "one record": [_rec()],
    "decay below tol": PRIOR + [_rec(110.0, 540.0, 1100.0, 11.0)],
    "decay above tol": PRIOR + [_rec(113.0, 500.0, 1000.0, 10.0)],
    "compile 1.9x the median": PRIOR + [_rec(compile_s=19.0)],
    "compile 2.1x the median": PRIOR + [_rec(compile_s=21.0)],
    "metric missing before": [_rec(dvbs2=None, peg=None), _rec(dvbs2=None, peg=None),
                              _rec(101.0, 600.0, 1200.0)],
    "older than the last three": [_rec(50.0)] + PRIOR + [_rec(103.0)],
}


def _metric_lines(text, metrics):
    return [ln for ln in text.splitlines() if ln.split(" ", 1)[0] in metrics]


@pytest.mark.parametrize("case", list(LEDGERS))
def test_check_equals_the_jax_tool(tmp_path, capsys, case):
    ledger = tmp_path / "kernels.json"
    if LEDGERS[case] is not None:
        ledger.write_text(json.dumps(LEDGERS[case]))
    jax_tool = _jax_tool(ledger)
    want_rc = jax_tool.check(0.12)
    want = capsys.readouterr().out
    got_rc = pr.check(0.12, str(ledger))
    got = capsys.readouterr().out
    assert got_rc == want_rc
    if LEDGERS[case] is None or len(LEDGERS[case]) < 2:
        assert got == want
    else:
        lines = _metric_lines(want, jax_tool.METRICS)
        assert lines and _metric_lines(got, jax_tool.METRICS) == lines
    assert set(jax_tool.METRICS) < set(pr.METRICS)
    assert (pr.COMPILE_TOL, jax_tool.COMPILE_TOL) == (1.0, 1.0)
    expect = {"no ledger": 1, "decay above tol": 1, "compile 2.1x the median": 1}
    assert got_rc == expect.get(case, 0)


def test_check_gates_build_seconds(tmp_path, capsys):
    """build_s (nvcc wall seconds) is gated like compile_s: against the
    median of the last three, at COMPILE_TOL."""
    ledger = tmp_path / "kernels_torch.json"
    prior = [_rec(build_s=s) for s in (20.0, 30.0, 21.0)]
    ledger.write_text(json.dumps(prior + [_rec(build_s=41.0)]))
    assert pr.check(0.12, str(ledger)) == 0
    ledger.write_text(json.dumps(prior + [_rec(build_s=43.0)]))
    assert pr.check(0.12, str(ledger)) == 1
    assert "build_s" in capsys.readouterr().out


def _skips(tmp_path, capsys, other):
    """Records of `other` between the newest card's: each is skipped with a
    line, and the newest is compared with its own card's records only."""
    hist = [_rec(100.0), _rec(50.0, card=other), _rec(102.0), _rec(45.0, card=other),
            _rec(105.0)]
    ledger = tmp_path / "kernels_torch.json"
    ledger.write_text(json.dumps(hist))
    assert pr.check(0.12, str(ledger)) == 0
    out = capsys.readouterr().out
    skipped = [ln for ln in out.splitlines() if ln.startswith("skipped record")]
    assert len(skipped) == 2
    assert all(f"card {other['name']}, {other['power_limit']}, newest on "
               f"{CARD['name']}, {CARD['power_limit']}" in ln for ln in skipped)
    assert "headline_decode_ms       105.000 vs best-of-3   100.000 (+5.0%) ok" in out
    ledger.write_text(json.dumps([_rec(50.0, card=other), _rec(105.0)]))
    assert pr.check(0.12, str(ledger)) == 0
    assert "headline_decode_ms     no prior records — skipped" in capsys.readouterr().out


def test_check_skips_records_of_another_card(tmp_path, capsys):
    """A faster card's records are no baseline."""
    _skips(tmp_path, capsys, dict(CARD, name="NVIDIA H200"))


def test_check_skips_records_of_another_power_limit(tmp_path, capsys):
    """Nor are the same card's at another power limit (a card held below
    700 W runs slower under load)."""
    _skips(tmp_path, capsys, dict(CARD, power_limit="500.00 W"))


def test_append_keeps_the_ledger_a_list(tmp_path):
    ledger = str(tmp_path / "perf" / "kernels_torch.json")
    pr.append(_rec(), ledger)
    pr.append(_rec(101.0), ledger)
    with open(ledger) as f:
        assert [r["headline_decode_ms"] for r in json.load(f)] == [100.0, 101.0]


@pytest.fixture(scope="module")
def regular(tmp_path_factory):
    """(JAX reload, port codec) of the regular (3,6) Z=40 code of
    tests/test_torch_qc_kernels.py, designed at 0.85, 40 iterations."""
    codec = JaxCodec.design(qc_expand(qc_generate_regular(3, 6, Z=40, nb=12, seed=3)),
                            0.85**2, max_iters=40, Nq_Cha=16, Nq_Msg=16)
    return carry(codec, tmp_path_factory.mktemp("c") / "regular.npz")


def test_label_draws_equal_the_jax_tool(regular):
    """The three decodes' frames: one default_rng(0), the headline draw
    (N=10000, 2 dB) then DVB-S2 and PEG (N=64800, 1.6 dB), as the JAX tool
    draws them, quantized by the JAX quantize_channel; small B."""
    jcodec, pcodec = regular
    b_head, b_e2e = 3, 2
    rng = np.random.default_rng(0)
    sig = float(jax_snr2sig(0.5, 2.0))
    y = 1.0 + sig * rng.standard_normal((b_head, 10000))
    want = [jcodec.quantize_channel(2.0 * y / sig**2)]
    for _ in ("dvbs2", "peg"):
        sg = float(jax_snr2sig(0.5, 1.6))
        yy = 1.0 + sg * rng.standard_normal((b_e2e, 64800))
        want.append(jcodec.quantize_channel(2.0 * yy / sg ** 2))

    rng = np.random.default_rng(0)
    got = [pr.labels(SimpleNamespace(nvar=n, quantize_channel=pcodec.quantize_channel), b, snr,
                     rng)
           for n, b, snr in ((10000, b_head, 2.0), (64800, b_e2e, 1.6), (64800, b_e2e, 1.6))]
    for (glc, glm), (wlc, wlm) in zip(got, want, strict=True):
        np.testing.assert_array_equal(glc, wlc)
        np.testing.assert_array_equal(glm, wlm)


def test_fused_chain_equals_jax_interpret(regular, monkeypatch):
    """Two chained CN -> VN iterations of the fused harness on the plain
    versions against the JAX Pallas passes in interpret mode, each pass's
    output the next one's input, iteration 0's parameters."""
    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    jcodec, pcodec = regular
    dec = pr.fused_decoder(pcodec, "cpu")
    assert dec.loop == "qc" and dec.dtype == torch.int16
    m0, cha = pr.fused_inputs(dec, B)
    assert int(m0.min()) >= -2000 and int(m0.max()) < 2000
    got = pr.fused_chain(dec, m0, cha, 2)

    spec = jax_prefix_spec(jcodec, dtype=np.int16)
    jd = JaxArith(jcodec, early_exit=True, spec=spec)
    m = m0.numpy()
    for _ in range(2):
        m_cn, _ = _pallas_cn(jd, m, np.int16)
        m, _, _ = _pallas_vn(jd, m_cn, cha.numpy(), 0, np.int16)
    real = dec.tables.vn_real.numpy()
    np.testing.assert_array_equal(got.numpy()[real], m[real])
    assert not np.array_equal(got.numpy()[real], m0.numpy()[real])
    # the plain chain, which the card's kernels are held against
    plain = pr.fused_chain(dec, m0, cha, 2, plain=True)
    np.testing.assert_array_equal(plain.numpy()[real], m[real])


def test_cold_units_leave_the_unit_table_as_it_was(tmp_path):
    """compile_s builds the headline decoder's units inside cold_units: a
    unit table of its own and the temporary directory, the table and the
    build directory before it back on leaving, also after a failure."""
    from lut_ldpc_torch.decoder import vn_codegen

    before, build_dir = vn_codegen._libs, vn_codegen.BUILD_DIR
    with pytest.raises(KeyError):
        with vn_codegen.cold_units(str(tmp_path)) as units:
            assert units is vn_codegen._libs and not units and units is not before
            assert vn_codegen.BUILD_DIR == str(tmp_path)
            assert vn_codegen.library.__globals__["_libs"] is units
            raise KeyError("a failed build")
    assert vn_codegen._libs is before and vn_codegen.BUILD_DIR == build_dir
