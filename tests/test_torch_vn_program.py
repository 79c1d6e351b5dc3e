"""The straight-line VN programs and the source generated from them.

Per degree class of a toy QC code, an irregular QC code (degrees 2-17), the
toy DVB-S2 analog (one phantom edge, an extra true-degree-1 class) and the
N=64800 PEG codec, in the int16 and the float32 spec, at the first, a middle
and the last iteration of the spec:

(a) ``eval_vn_program`` (two shared sweeps, straddled ops per output)
    against ``qc_kernels._vn_compute`` (the whole tree for every output);
(b) against the JAX package's ``vn_std_pass`` (``_vn_class_compute`` in
    Pallas interpret mode) on a small graph without circulant structure;
(c) the generated class bodies, compiled as host C++ with
    ``g++ -O2 -ffp-contract=off``, against ``_vn_compute``;
(d) the generated text is the same twice, hashes alike, and declares no array
    that a body could index at run time.

Inputs come from a numpy seed: the iteration's value alphabet, zeros, and the
class's own thresholds and their negatives, so that sums land on thresholds
and on the s == 0 tie.  Tolerance: zero everywhere.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lut_ldpc_tpu.core.tanner import TannerGraph as JaxTanner
from lut_ldpc_tpu.decoder import LUTCodec as JaxCodec
from lut_ldpc_tpu.decoder import qc_kernels as jqk
from lut_ldpc_tpu.decoder.arith import build_arith_prefix_spec as jax_prefix_spec
from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder as JaxArith

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_carry import carry  # noqa: E402
from util_codes import random_regular_H  # noqa: E402

from lut_ldpc_torch import bench_n64800 as b64  # noqa: E402
from lut_ldpc_torch.core import qc  # noqa: E402
from lut_ldpc_torch.core.dvbs2 import periodic_qc_structure  # noqa: E402
from lut_ldpc_torch.core.ensemble import LDPCEnsemble  # noqa: E402
from lut_ldpc_torch.decoder import (ArithLUTDecoder, LUTCodec,  # noqa: E402
                                    build_arith_prefix_spec, build_arith_spec)
from lut_ldpc_torch.decoder import qc_kernels as qk  # noqa: E402
from lut_ldpc_torch.decoder import vn_codegen as cg  # noqa: E402
from lut_ldpc_torch.decoder.hybrid import root_levels  # noqa: E402
from lut_ldpc_torch.decoder.vn_program import (build_vn_program,  # noqa: E402
                                               eval_vn_program)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [np.int16, np.float32]
# codec -> degrees of its VN classes, in class order (the phantom codec's
# last class is the true degree of its phantom node: no kernel row has it)
CLASSES = {"regular": [3], "irregular": [2, 3, 9, 17], "phantom": [2, 3, 4, 1],
           "peg64800": [2, 3, 9, 17]}
KERNEL_CLASSES = {"regular": 1, "irregular": 4, "phantom": 3, "peg64800": 4}
CASES = [(name, ci) for name, degs in CLASSES.items() for ci in range(len(degs))]
N = 384  # nodes per class in the comparisons


def _toy_dvbs2():
    Z, q = 16, 4
    M = Z * q
    groups = [[0, 9, 34], [3, 21, 46], [1, 6, 11, 36], [2, 7, 23, 16]]
    cols = [np.array(sorted((x + t * q) % M for x in g))
            for g in groups for t in range(Z)]
    cols += [np.array([j] if j == M - 1 else [j, j + 1]) for j in range(M)]
    st, _, _ = periodic_qc_structure(cols, len(cols), M, Z)
    return qc.qc_expand(st)


@pytest.fixture(scope="module")
def codecs():
    ens = LDPCEnsemble.read(os.path.join(
        REPO, "ensembles", "rate0.50_dv02-17_dc08-09_lut_q4.ens"))
    return {
        "regular": LUTCodec.design(
            qc.qc_expand(qc.qc_generate_regular(3, 6, Z=40, nb=12, seed=3)),
            0.85**2, max_iters=40, Nq_Cha=16, Nq_Msg=16),
        "irregular": LUTCodec.design(
            qc.qc_expand(qc.qc_generate_irregular(ens, Z=24, nb=60, seed=1)),
            0.90**2, max_iters=10, Nq_Cha=16, Nq_Msg=16),
        "phantom": LUTCodec.design(_toy_dvbs2(), 0.9**2, max_iters=10,
                                   Nq_Cha=16, Nq_Msg=16),
        "peg64800": b64.build_codec("peg"),
    }


@pytest.fixture(scope="module")
def decoders(codecs):
    """(codec name, dtype name) -> CPU ArithLUTDecoder: the phantom codec on
    its full spec (the one that holds its true-degree-1 trees), the others on
    the prefix spec of the dtype."""
    out = {}
    for name, codec in codecs.items():
        for dt in DTYPES:
            build = build_arith_spec if name == "phantom" else build_arith_prefix_spec
            spec = build(codec, dtype=dt)
            dec = ArithLUTDecoder(codec, "cpu", spec=spec)
            assert [c.degree for c in dec.params.classes] == CLASSES[name]
            assert dec.params.kernel_classes == KERNEL_CLASSES[name]
            out[name, np.dtype(dt).name] = dec
    return out


def _iterations(params):
    S = params.num_iters
    return sorted({0, S // 2, S - 1})


def _inputs(dec, ci, it, seed):
    """msg (d, N) and ch (N,) float32: the iteration's alphabet, zeros, the
    class's thresholds and their negatives; integer-valued for an int16
    spec."""
    cls = dec.params.classes[ci]
    prm = dec.params.prm_host[it]
    pool = [np.asarray(root_levels(dec.spec, it), np.float32), np.zeros(4, np.float32)]
    for op in cls.ops:
        thr = prm[op.off : op.off + op.nthr]
        pool += [thr, -thr]
    pool = np.concatenate(pool)
    pool = pool[np.isfinite(pool)]
    if dec.dtype == torch.int16:
        pool = np.round(pool)
    rng = np.random.default_rng(seed)
    msg = pool[rng.integers(0, len(pool), (cls.degree, N))]
    # pairs that cancel: sums at zero take the tie branch
    msg[-1, : N // 8] = -msg[0, : N // 8]
    cha_pool = np.concatenate([np.asarray(dec.spec.leaf_cha, np.float32),
                               np.zeros(2, np.float32)])
    ch = cha_pool[rng.integers(0, len(cha_pool), N)]
    return torch.as_tensor(msg), torch.as_tensor(ch)


def _assert_same(got, want):
    outs, neg0, agree = got
    w_outs, w_neg0, w_agree = want
    assert len(outs) == len(w_outs)
    for i, (a, b) in enumerate(zip(outs, w_outs)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"output {i}")
    assert torch.equal(neg0, w_neg0)
    assert (agree is None) == (w_agree is None)
    if agree is not None:
        assert torch.equal(agree, w_agree)


# ---------------------------------------------------------------------------
# (a) the program against the full leave-one-out
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name,ci", CASES, ids=lambda v: str(v))
def test_program_equals_full_leave_one_out(decoders, name, ci, dtype):
    dec = decoders[name, np.dtype(dtype).name]
    cls = dec.params.classes[ci]
    prog = build_vn_program(cls)
    d = cls.degree
    assert prog.degree == d and len(prog.outputs) == d
    # two sweeps, then per inner output only the straddled ops
    full = d * len(cls.ops)
    assert len(prog.steps) <= full and (d < 4 or len(prog.steps) < full)
    if d == 17:
        assert len(prog.steps) == 96
    for it in _iterations(dec.params):
        msg, ch = _inputs(dec, ci, it, seed=100 * ci + it)
        prm = dec.params.prm[it]
        _assert_same(eval_vn_program(prog, msg, ch, prm),
                     qk._vn_compute(cls, msg, ch, prm))


# ---------------------------------------------------------------------------
# (b) the program against the JAX package's _vn_class_compute
# ---------------------------------------------------------------------------
KSLOTS = ("thr", "levels", "tie_lo", "tie_hi")


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """(JAX reload, port codec) of a small graph without circulant structure:
    degree-3 variables, one of degree 1, an irregular check."""
    H = random_regular_H(96, 3, 6, seed=3).copy()
    H[:, 0] = 0
    H[0, 0] = 1
    codec = JaxCodec.design(JaxTanner.from_dense(H), 0.81, max_iters=6,
                            Nq_Cha=16, Nq_Msg=16)
    return carry(codec, tmp_path_factory.mktemp("vnprog") / "mixed.npz")


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_program_equals_jax_class_compute(mixed, dtype, monkeypatch):
    monkeypatch.setenv("LUT_LDPC_PALLAS_INTERPRET", "1")
    jcodec, pcodec = mixed
    jd = JaxArith(jcodec, early_exit=True, spec=jax_prefix_spec(jcodec, dtype=dtype))
    spec = build_arith_prefix_spec(pcodec, dtype=dtype)
    port = ArithLUTDecoder(pcodec, "cpu", spec=spec)
    tab, lay, B = port.tables, jd.layout, 8
    structs = [jd._var_struct[di] for di in jd._spec_di]
    flags = [jd._op_flags[di] for di in jd._spec_di]
    use_tots = [st.ops[0].operands == tuple(range(blk.degree - 1))
                and blk.degree >= 3 and jd._is_int
                for st, blk in zip(structs, lay.vn_blocks)]
    keys = jqk.kernel_op_keys(flags)
    for it in _iterations(port.params):
        rng = np.random.default_rng(30 + it)
        table = np.concatenate([np.asarray(root_levels(spec, it)),
                                np.zeros(2, np.dtype(dtype))])
        m_new = table[rng.integers(0, len(table), (tab.rows_vn, B))]
        leaf = np.asarray(spec.leaf_cha)
        cha = leaf[rng.integers(0, len(leaf), (tab.nvar_pad, B))]
        prm_it = [[{ks: op[k][it] for ks, k in zip(KSLOTS, kk)}
                   for op, kk in zip(jd._var_xs[jd._spec_di[bi]], keys[bi])]
                  for bi in range(len(structs))]
        j_out, j_bits, _ = jqk.vn_std_pass(
            jnp.asarray(m_new), jnp.asarray(cha), lay.vn_blocks, lay.nvar_pad,
            structs, prm_it, use_tots, flags)
        j_out, j_bits = np.array(j_out), np.array(j_bits)  # writable copies
        m_t, cha_t = torch.as_tensor(m_new), torch.as_tensor(cha)
        for cls, blk in zip(port.params.classes, tab.vn_blocks):
            n0, nr = blk.node_start, blk.num_nodes
            outs, neg0, _ = eval_vn_program(
                build_vn_program(cls), qk._planes(m_t, blk, B),
                cha_t[n0 : n0 + nr], port.params.prm[it])
            got = torch.stack(outs).to(port.dtype).numpy()
            want = qk._planes(torch.as_tensor(j_out), blk, B).numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(neg0.numpy().astype(np.int8),
                                          j_bits[n0 : n0 + nr])


# ---------------------------------------------------------------------------
# (c) the generated bodies as host C++
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def host_libs(decoders, tmp_path_factory):
    """(codec name, dtype name) -> the generated unit compiled for the host,
    or None without a compiler."""
    if shutil.which("g++") is None:
        return None
    tmp = tmp_path_factory.mktemp("vn_host")
    out = {}
    for (name, dt), dec in decoders.items():
        src, lib = tmp / f"{name}_{dt}.cpp", tmp / f"{name}_{dt}.so"
        src.write_text(cg.generate_source(dec.params, dec.dtype, "std"))
        subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                        "-std=c++17", "-o", str(lib), str(src)], check=True,
                       capture_output=True, timeout=300)
        h = ctypes.CDLL(str(lib))
        fp = ctypes.POINTER(ctypes.c_float)
        h.lut_vn_host_eval.argtypes = [ctypes.c_int, fp, fp, fp, fp, ctypes.c_int]
        h.lut_vn_host_eval.restype = ctypes.c_int
        out[name, dt] = h
    return out


KERNEL_CASES = [(n, ci) for n, ci in CASES if ci < KERNEL_CLASSES[n]]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name,ci", KERNEL_CASES, ids=lambda v: str(v))
def test_generated_body_on_host_equals_full_leave_one_out(decoders, host_libs,
                                                          name, ci, dtype):
    if host_libs is None:
        pytest.skip("no g++ on this host")
    dt = np.dtype(dtype).name
    dec, lib = decoders[name, dt], host_libs[name, dt]
    cls = dec.params.classes[ci]
    fp = ctypes.POINTER(ctypes.c_float)
    for it in _iterations(dec.params):
        msg, ch = _inputs(dec, ci, it, seed=200 * ci + it)
        m = np.ascontiguousarray(msg.numpy())
        c = np.ascontiguousarray(ch.numpy())
        row = np.ascontiguousarray(dec.params.prm_host[it])
        out = np.empty_like(m)
        rc = lib.lut_vn_host_eval(ci, row.ctypes.data_as(fp), m.ctypes.data_as(fp),
                                  c.ctypes.data_as(fp), out.ctypes.data_as(fp), N)
        assert rc == 0
        want, _, _ = qk._vn_compute(cls, msg, ch, dec.params.prm[it])
        np.testing.assert_array_equal(out, torch.stack(want).numpy())
    assert lib.lut_vn_host_eval(dec.params.kernel_classes, None, None, None, None, 0) == -1


# ---------------------------------------------------------------------------
# (d) the text
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["qc", "std"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(CLASSES))
def test_generated_text_is_deterministic_and_straight_line(decoders, name, dtype,
                                                           kind):
    dec = decoders[name, np.dtype(dtype).name]
    text = cg.generate_source(dec.params, dec.dtype, kind)
    again = cg.generate_source(dec.params, dec.dtype, kind)
    assert text == again and cg.source_hash(text) == cg.source_hash(again)
    assert cg.source_hash(text) != cg.source_hash(text + "\n")
    other = cg.generate_source(dec.params, dec.dtype, "std" if kind == "qc" else "qc")
    assert cg.source_hash(other) != cg.source_hash(text)
    assert text.count("LUT_VN_FN void vn_class_") == dec.params.kernel_classes
    bodies = re.sub(r"//[^\n]*", "", text[: text.index("#define LUT_VN_FOR_CLASSES")])
    # every subscript in the bodies is a literal; the only arrays are the
    # parameter slices and the frames' argument arrays of VnClass<C>::run
    subs = set(re.findall(r"\[([^\]]*)\]", bodies))
    assert subs and all(s.isdigit() for s in subs), subs
    decls = re.findall(r"\b(?:float|int)\s+\(?&?(\w+)\)?\[", bodies)
    assert set(decls) <= {"v", "m", "o"}, decls
    for word in ("for", "while", "op_info", "opnds", "__ldg"):
        assert not re.search(rf"\b{word}\b", bodies), word


def test_build_needs_a_compiler_and_never_falls_back(decoders, monkeypatch, tmp_path):
    """Where nvcc is missing the build raises; nothing else is tried."""
    monkeypatch.setattr(cg, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cg, "nvcc_path", lambda: str(tmp_path / "no-nvcc"))
    dec = decoders["regular", "int16"]
    with pytest.raises(OSError):
        cg.start_build(dec.params, dec.dtype, "qc", force=True)
    assert not list(tmp_path.glob("*.so"))
