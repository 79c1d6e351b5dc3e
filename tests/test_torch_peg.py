"""PEG construction and the numpy CLIs of the port (lut_ldpc_torch/core/peg.py,
cli/{peg_gen,alist2ens,ens2deg,dat2alist,dump_stimuli}.py) against the JAX
package's, on the repo's ensembles/ and codes/ assets: the same graphs
(native against native, the Python fallback against the Python fallback),
the same files and the same printed text.  Also: the port's native library
is named by its sources' text, so a library from other sources (one
without peg_construct) is never loaded."""

import os
import subprocess

import numpy as np
import pytest

from lut_ldpc_tpu.cli import alist2ens as j_alist2ens
from lut_ldpc_tpu.cli import dat2alist as j_dat2alist
from lut_ldpc_tpu.cli import dump_stimuli as j_dump
from lut_ldpc_tpu.cli import ens2deg as j_ens2deg
from lut_ldpc_tpu.cli import peg_gen as j_peg_gen
from lut_ldpc_tpu.core import peg as jpeg
from lut_ldpc_tpu.core.ensemble import LDPCEnsemble as JaxEnsemble
from lut_ldpc_tpu.core.tanner import TannerGraph as JaxGraph
from lut_ldpc_tpu.decoder import LUTCodec as JaxCodec

from lut_ldpc_torch import _native
from lut_ldpc_torch.cli import alist2ens, dat2alist, dump_stimuli, ens2deg, peg_gen
from lut_ldpc_torch.core import peg
from lut_ldpc_torch.core.ensemble import LDPCEnsemble

from util_codes import random_regular_H

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENS36 = os.path.join(REPO, "ensembles", "rate0.50_dv03_dc06.ens")
ENS_IRR = os.path.join(REPO, "ensembles", "rate0.50_dv02-04_dc05-06.ens")


@pytest.mark.parametrize("ens_path,M,N,sgl,seed", [
    (ENS36, 64, 128, 1, 11),
    (ENS36, 120, 240, 0, 5),
    (ENS_IRR, 250, 500, 1, 1234),
])
def test_peg_native_equals_jax(ens_path, M, N, sgl, seed):
    if _native.get_lib() is None:
        pytest.skip("no C++ compiler: the fallback is held below")
    g, lg = peg.peg_code_from_ensemble(LDPCEnsemble.read(ens_path), M, N, sgl, seed=seed)
    gj, lgj = jpeg.peg_code_from_ensemble(JaxEnsemble.read(ens_path), M, N, sgl, seed=seed)
    assert np.array_equal(g.to_dense(), gj.to_dense())
    assert np.array_equal(lg, lgj)
    assert (g.to_dense().sum(axis=0) == peg.degree_sequence_from_ensemble(
        LDPCEnsemble.read(ens_path), N)).all()


@pytest.mark.parametrize("M,N,sgl,girth", [(24, 48, 1, 100000), (30, 60, 0, 6)])
def test_peg_fallback_equals_jax(M, N, sgl, girth):
    seq = peg.degree_sequence_from_ensemble(LDPCEnsemble.read(ENS36), N)
    out, lg = peg._peg_python(M, N, seq, sgl, girth, 7)
    out_j, lg_j = jpeg._peg_python(M, N, seq, sgl, girth, 7)
    assert np.array_equal(out, out_j) and np.array_equal(lg, lg_j)


def _both(tmp_path, monkeypatch, capsys, jax_main, port_main, args):
    """Run both CLIs with `args` from two working directories; returns
    {side: (printed text, {file: bytes})}."""
    out = {}
    for side, main in (("jax", jax_main), ("port", port_main)):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        capsys.readouterr()
        assert main(list(args)) == 0
        out[side] = (capsys.readouterr().out,
                     {f: (d / f).read_bytes() for f in sorted(os.listdir(d))})
    return out


CLI_CASES = {
    "peg_gen": (j_peg_gen.main, peg_gen.main,
                ["500", "1000", "c.alist", ENS36, "--seed", "3", "--girth-log", "g.txt"]),
    "peg_gen_concentrated": (j_peg_gen.main, peg_gen.main,
                             ["250", "500", "c.alist", ENS_IRR, "--sgl-concent", "0"]),
    "alist2ens": (j_alist2ens.main, alist2ens.main,
                  [os.path.join(REPO, "codes", "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist"),
                   "c.ens"]),
    "ens2deg": (j_ens2deg.main, ens2deg.main, [ENS_IRR, "c.deg"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_equals_jax(tmp_path, monkeypatch, capsys, case):
    jax_main, port_main, args = CLI_CASES[case]
    out = _both(tmp_path, monkeypatch, capsys, jax_main, port_main, args)
    assert out["port"] == out["jax"]
    assert out["port"][1] and out["port"][0].startswith("Wrote")


def test_dat2alist_equals_jax(tmp_path, monkeypatch, capsys):
    H = random_regular_H(60, 3, 6, seed=2)
    rows = [np.nonzero(r)[0] + 1 for r in H]
    width = max(len(r) for r in rows) + 1  # one padding zero a row
    dat = tmp_path / "h.dat"
    dat.write_text(f"{H.shape[1]}\n{H.shape[0]}\n{width}\n" + "".join(
        " ".join(map(str, list(r) + [0] * (width - len(r)))) + "\n" for r in rows))
    out = _both(tmp_path, monkeypatch, capsys, j_dat2alist.main, dat2alist.main,
                [str(dat), "h.alist"])
    assert out["port"] == out["jax"]
    from lut_ldpc_torch.core.alist import read_alist

    assert np.array_equal(read_alist(str(tmp_path / "port" / "h.alist")), H)


@pytest.fixture(scope="module")
def codec_files(tmp_path_factory):
    """A small designed codec saved as .npz and as .it by the JAX package."""
    from lut_ldpc_tpu.ops.pmf import snr2sig

    d = tmp_path_factory.mktemp("codec")
    c = JaxCodec.design(JaxGraph.from_dense(random_regular_H(48, 3, 6, seed=4)),
                        float(snr2sig(0.5, 2.0)) ** 2, max_iters=5, Nq_Cha=16, Nq_Msg=16)
    c.save(str(d / "c.npz"))
    c.save_itfile(str(d / "c.it"))
    return d


@pytest.mark.parametrize("fmt,verbosity", [("npz", 1), ("it", 2), ("npz", 3)])
def test_dump_stimuli_equals_jax(tmp_path, monkeypatch, capsys, codec_files, fmt, verbosity):
    args = [str(codec_files / f"c.{fmt}"), "--snr", "1.5", "--frames", "3", "--seed", "5",
            "--verbosity", str(verbosity)]
    out = _both(tmp_path, monkeypatch, capsys, j_dump.main, dump_stimuli.main, args)
    assert out["port"] == out["jax"] and len(out["port"][0]) > 100
    (tmp_path / "file").mkdir()
    out = _both(tmp_path / "file", monkeypatch, capsys, j_dump.main, dump_stimuli.main,
                args + ["-o", "s.txt"])
    assert out["port"] == out["jax"] and out["port"][1]["s.txt"]


def test_stale_library_without_peg_is_not_loaded(tmp_path, monkeypatch):
    """A library built from lut_core.cpp alone, under the old fixed name
    and newer than the sources (what an mtime check would accept), sits in
    the build directory: the loader names its library by both sources'
    text, builds that, and its library has peg_construct."""
    import ctypes

    if subprocess.run(["which", "g++"], capture_output=True).returncode:
        pytest.skip("no C++ compiler")
    monkeypatch.setattr(_native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    old = tmp_path / "liblutcore.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _native._SRCS[0], "-o",
                    str(old)], check=True, capture_output=True, timeout=120)
    assert not hasattr(ctypes.CDLL(str(old)), "peg_construct")
    lib = _native.get_lib()
    path = _native.lib_path()
    assert os.path.dirname(path) == str(tmp_path) and path != str(old)
    assert os.path.samefile(lib._name, path) and hasattr(lib, "peg_construct")
    # another source text names another file
    src = tmp_path / "peg.cpp"
    src.write_text(open(_native._SRCS[1]).read() + "\n// edited\n")
    monkeypatch.setattr(_native, "_SRCS", [_native._SRCS[0], str(src)])
    assert _native.lib_path() != path


def test_fallback_without_native(monkeypatch):
    """LUT_LDPC_NO_NATIVE: no library, and PEG runs the Python fallback."""
    monkeypatch.setenv("LUT_LDPC_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    assert _native.get_lib() is None
    g, lg = peg.peg_code_from_ensemble(LDPCEnsemble.read(ENS36), 24, 48, seed=7)
    seq = peg.degree_sequence_from_ensemble(LDPCEnsemble.read(ENS36), 48)
    out, lg_py = jpeg._peg_python(24, 48, seq, 1, 100000, 7)
    assert np.array_equal(lg, lg_py)
    assert (g.to_dense().sum(axis=0) == 3).all()
