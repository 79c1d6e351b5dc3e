"""The per-degree-block VN pass as a generated straight-line program, and
the block loop that runs it with its c2v gather folded in.

Block programs (``block_kernels.vn_block_program`` ->
``vn_program.build_block_program``) of three small codes designed by the
port: a graph with a degree-1 variable among degree-3 ones, a (4,8) QC code
and an irregular QC code (variable degrees 2, 3, 9, 17); int16 and float32
prefix specs (int16 blocks of degree >= 3 sum op 0 as total minus self,
``use_tot``); the standard leave-one-out table and a non-standard one (each
row's other messages in reverse order).  Inputs from a numpy seed: the
iteration's value alphabet, zeros, the block's own thresholds and their
negatives, and pairs that cancel, so that sums land on thresholds and on
the s == 0 tie.

(a) ``eval_vn_program`` of the block program against ``run_vn_block_ref``
    (the whole tree for every output) at the first, a middle and the last
    iteration, and at the middle one for degrees 1-4 (and one degree-9
    case) against the JAX package's ``pallas_kernels.vn_pass`` in Pallas
    interpret mode;
(b) on the standard table the step count equals ``build_vn_program``'s;
(c) the generated "block" unit compiled as host C++ (``g++ -O2
    -ffp-contract=off``) against ``eval_vn_program``;
(d) its text is deterministic and straight-line;
(e) the kernel library's file names follow the text of the sources and the
    compiler flags, not the files' modification times (no nvcc needed);
(f) the block-loop decode equals the std loop, the JAX decoder's plain loop
    and ``decode_ref`` on the N=500 PEG code.

Tolerance: zero everywhere.
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
from jax.experimental.pallas import tpu as pltpu

from lut_ldpc_tpu.core.tanner import TannerGraph as JaxTanner
from lut_ldpc_tpu.decoder import LUTCodec as JaxCodec
from lut_ldpc_tpu.decoder import pallas_kernels as jpk
from lut_ldpc_tpu.decoder.arith import build_arith_spec as jax_full_spec
from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder as JaxArith

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_carry import carry, labels  # noqa: E402
from util_codes import random_regular_H  # noqa: E402

from lut_ldpc_torch.core import qc  # noqa: E402
from lut_ldpc_torch.core.ensemble import LDPCEnsemble  # noqa: E402
from lut_ldpc_torch.core.tanner import TannerGraph  # noqa: E402
from lut_ldpc_torch.decoder import (ArithLUTDecoder, LUTCodec,  # noqa: E402
                                    build_arith_prefix_spec, build_arith_spec)
from lut_ldpc_torch.decoder import block_kernels as bk  # noqa: E402
from lut_ldpc_torch.decoder import nvcc  # noqa: E402
from lut_ldpc_torch.decoder import qc_kernels as qk  # noqa: E402
from lut_ldpc_torch.decoder import vn_codegen as cg  # noqa: E402
from lut_ldpc_torch.decoder.hybrid import root_levels  # noqa: E402
from lut_ldpc_torch.decoder.layout import leave_one_out_idx  # noqa: E402
from lut_ldpc_torch.decoder.vn_program import (build_vn_program,  # noqa: E402
                                               eval_vn_program)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [np.int16, np.float32]
DEGREES = {"mixed": [1, 3], "regular4": [4], "irregular": [2, 3, 9, 17]}
LOOS = ["standard", "reversed"]
N_PAD, N_REAL, B_JAX = 8, 7, 128
# the interpreted TPU kernel takes about a minute at degree 9: one case
JAX_CASES = {(d, "standard") for d in range(1, 5)} | {(d, "reversed") for d in range(1, 5)}
JAX_CASES |= {(9, "reversed")}


def _reversed_loo(d):
    """Row i: the other messages in reverse order, then the channel."""
    return np.stack([np.array([j for j in range(d) if j != i][::-1] + [d])
                     for i in range(d)])


@pytest.fixture(scope="module")
def codecs():
    H = random_regular_H(96, 3, 6, seed=3).copy()
    H[:, 0] = 0
    H[0, 0] = 1
    ens = LDPCEnsemble.read(os.path.join(
        REPO, "ensembles", "rate0.50_dv02-17_dc08-09_lut_q4.ens"))
    design = lambda g, sig: LUTCodec.design(g, sig**2, max_iters=10, Nq_Cha=16, Nq_Msg=16)
    return {
        "mixed": design(TannerGraph.from_dense(H), 0.9),
        "regular4": design(qc.qc_expand(qc.qc_generate_regular(4, 8, Z=16, nb=8, seed=1)),
                           0.8),
        "irregular": design(qc.qc_expand(qc.qc_generate_irregular(ens, Z=24, nb=60, seed=1)),
                            0.9),
    }


@pytest.fixture(scope="module")
def decoders(codecs):
    """(codec name, dtype name) -> CPU block-loop ArithLUTDecoder on the
    prefix spec."""
    out = {}
    for name, codec in codecs.items():
        for dt in DTYPES:
            dec = ArithLUTDecoder(codec, "cpu", spec=build_arith_prefix_spec(codec, dtype=dt),
                                  loop="blocks")
            assert dec.loop == "blocks"
            assert [b.degree for b in dec.layout.vn_blocks] == DEGREES[name]
            out[name, np.dtype(dt).name] = dec
    return out


def _program(dec, bi, loo):
    """The packed program of VN block bi for the table `loo`: "standard"
    (the decoder's own), "reversed" or an array."""
    prog = dec._progs[bi]
    if isinstance(loo, str) and loo == "standard":
        return prog
    table = _reversed_loo(prog.degree) if isinstance(loo, str) else loo
    di = dec.spec.degrees.index(prog.degree)
    trees = [dec.spec.var_trees[it][di] for it in range(dec.S)]
    prm = [[dict(thr=op.thresholds, levels=op.levels, tie_lo=op.tie_lo,
                 tie_hi=op.tie_hi) for op in t.ops] for t in trees]
    return bk.vn_block_program(trees[0], prm, table, prog.use_tot, "cpu")


def _inputs(dec, prog, it, B, seed):
    """m3 (d, N_PAD, B) and cha (N_PAD, B) in the decoder's dtype."""
    row = prog.prm_host[it]
    pool = [np.asarray(root_levels(dec.spec, it), np.float32), np.zeros(4, np.float32)]
    for op in prog.ops:
        thr = row[op.off : op.off + op.nthr]
        pool += [thr, -thr]
    pool = np.concatenate(pool)
    pool = pool[np.isfinite(pool)]
    if dec.dtype == torch.int16:
        pool = np.round(pool)
    rng = np.random.default_rng(seed)
    d = prog.degree
    m3 = pool[rng.integers(0, len(pool), (d, N_PAD, B))]
    m3[-1, :, : B // 8] = -m3[0, :, : B // 8]  # pairs that cancel
    cha_pool = np.concatenate([np.asarray(dec.spec.leaf_cha, np.float32),
                               np.zeros(2, np.float32)])
    cha = cha_pool[rng.integers(0, len(cha_pool), (N_PAD, B))]
    np_dt = np.int16 if dec.dtype == torch.int16 else np.float32
    return torch.as_tensor(m3.astype(np_dt)), torch.as_tensor(cha.astype(np_dt))


CASES = [(name, bi) for name, degs in DEGREES.items() for bi in range(len(degs))]


# ---------------------------------------------------------------------------
# (a), (b) the program against the whole tree per output and the TPU kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("loo", LOOS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name,bi", CASES, ids=lambda v: str(v))
def test_block_program_equals_plain_version_and_jax(decoders, name, bi, dtype, loo):
    dec = decoders[name, np.dtype(dtype).name]
    prog = _program(dec, bi, loo)
    d = prog.degree
    if loo == "standard":
        assert (len(prog.program.steps)
                == len(build_vn_program(dec.params.classes[bi]).steps))
        if d == 17:
            assert len(prog.program.steps) == 96
    assert len(prog.program.steps) <= max(d, 1) * len(prog.ops)
    for it in sorted({0, dec.S // 2, dec.S - 1}):
        m3, cha = _inputs(dec, prog, it, B_JAX + 8, seed=100 * d + it)
        out, bits, unan = bk.run_vn_block_ref(m3, cha, prog, it, N_REAL)
        outs, neg0, agree = eval_vn_program(prog.program, m3[:, :N_REAL],
                                            cha[:N_REAL], prog.prm[it])
        got = torch.stack(outs).to(m3.dtype)
        np.testing.assert_array_equal(got.numpy(), out[:, :N_REAL].numpy())
        np.testing.assert_array_equal(neg0.numpy().astype(np.uint8),
                                      bits[:N_REAL].numpy())
        want_unan = (torch.ones_like(unan) if agree is None
                     else agree.all(dim=0))
        assert torch.equal(want_unan, unan)
        if (d, loo) not in JAX_CASES or it != dec.S // 2 or (d == 9 and dtype != np.int16):
            continue
        di = dec.spec.degrees.index(d)
        tree = dec.spec.var_trees[it][di]
        prm_it = [dict(thr=np.asarray(op.thresholds, np.float32),
                       levels=np.asarray(op.levels, np.float32),
                       tie_lo=np.float32(op.tie_lo), tie_hi=np.float32(op.tie_hi))
                  for op in tree.ops]
        with pltpu.force_tpu_interpret_mode():
            j_out, j_bits, _ = jpk.vn_pass(
                jnp.asarray(m3[:, :, :B_JAX].numpy()), jnp.asarray(cha[:, :B_JAX].numpy()),
                tree, prm_it, prog.loo, prog.use_tot, N_REAL)
        np.testing.assert_array_equal(got[:, :, :B_JAX].numpy(),
                                      np.asarray(j_out)[:, :N_REAL])
        np.testing.assert_array_equal(bits[:N_REAL, :B_JAX].numpy(),
                                      np.asarray(j_bits)[:N_REAL])


def test_use_tot_and_table_shape_the_program(decoders):
    """Under use_tot op 0 is one total-minus-self step per output; another
    table changes the steps, not the function (held above)."""
    dec = decoders["irregular", "int16"]
    bi = [b.degree for b in dec.layout.vn_blocks].index(3)
    prog = dec._progs[bi]
    assert prog.use_tot
    minus = [st for st in prog.program.steps if st.minus is not None]
    assert sorted(st.minus[1] for st in minus) == [0, 1, 2]
    assert all(st.op == 0 for st in minus)
    other = _program(dec, bi, "reversed")
    assert other.key != prog.key and other.program != prog.program
    again = _program(dec, bi, leave_one_out_idx(4, 3))
    assert again.key == prog.key and again.program == prog.program


# ---------------------------------------------------------------------------
# (c) the generated unit as host C++
# ---------------------------------------------------------------------------
def _unit_programs(dec):
    return [_program(dec, bi, loo) for loo in LOOS
            for bi in range(len(dec.layout.vn_blocks))]


@pytest.fixture(scope="module")
def host_libs(decoders, tmp_path_factory):
    """(codec name, dtype name) -> the block unit of the standard and the
    reversed programs compiled for the host, or None without a compiler."""
    if shutil.which("g++") is None:
        return None
    tmp = tmp_path_factory.mktemp("vn_block_host")
    out = {}
    for (name, dt), dec in decoders.items():
        src, lib = tmp / f"{name}_{dt}.cpp", tmp / f"{name}_{dt}.so"
        src.write_text(cg.block_source(_unit_programs(dec), dec.dtype))
        subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                        "-std=c++17", "-o", str(lib), str(src)], check=True,
                       capture_output=True, timeout=300)
        h = ctypes.CDLL(str(lib))
        fp = ctypes.POINTER(ctypes.c_float)
        h.lut_vn_host_eval.argtypes = [ctypes.c_int, fp, fp, fp, fp, ctypes.c_int]
        h.lut_vn_host_eval.restype = ctypes.c_int
        out[name, dt] = h
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(DEGREES))
def test_generated_block_body_on_host_equals_program(decoders, host_libs, name, dtype):
    if host_libs is None:
        pytest.skip("no g++ on this host")
    dt = np.dtype(dtype).name
    dec, lib = decoders[name, dt], host_libs[name, dt]
    fp = ctypes.POINTER(ctypes.c_float)
    progs = _unit_programs(dec)
    for c, prog in enumerate(progs):
        for it in sorted({0, dec.S - 1}):
            m3, cha = _inputs(dec, prog, it, 48, seed=300 * c + it)
            msg = np.ascontiguousarray(m3.numpy().astype(np.float32).reshape(prog.degree, -1))
            ch = np.ascontiguousarray(cha.numpy().astype(np.float32).reshape(-1))
            row = np.ascontiguousarray(prog.prm_host[it])
            out = np.empty_like(msg)
            assert lib.lut_vn_host_eval(c, row.ctypes.data_as(fp), msg.ctypes.data_as(fp),
                                        ch.ctypes.data_as(fp), out.ctypes.data_as(fp),
                                        msg.shape[1]) == 0
            want, _, _ = eval_vn_program(prog.program, torch.as_tensor(msg),
                                         torch.as_tensor(ch), prog.prm[it])
            np.testing.assert_array_equal(out, torch.stack(want).numpy())
    assert lib.lut_vn_host_eval(len(progs), None, None, None, None, 0) == -1


# ---------------------------------------------------------------------------
# (d) the text
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(DEGREES))
def test_block_text_is_deterministic_and_straight_line(decoders, name, dtype):
    dec = decoders[name, np.dtype(dtype).name]
    progs = _unit_programs(dec)
    text = cg.block_source(progs, dec.dtype)
    assert text == cg.block_source(_unit_programs(dec), dec.dtype)
    assert cg.source_hash(text) == cg.source_hash(cg.block_source(progs, dec.dtype))
    assert "#define LUT_VN_BLOCK 1" in text
    assert text.count("LUT_VN_FN void vn_class_") == len(progs)
    other = torch.float32 if dec.dtype == torch.int16 else torch.int16
    assert cg.source_hash(cg.block_source(progs, other)) != cg.source_hash(text)
    assert cg.source_hash(cg.block_source(progs[::-1], dec.dtype)) != cg.source_hash(text)
    bodies = re.sub(r"//[^\n]*", "", text[: text.index("#define LUT_VN_FOR_CLASSES")])
    subs = set(re.findall(r"\[([^\]]*)\]", bodies))
    assert subs and all(s.isdigit() for s in subs), subs
    decls = re.findall(r"\b(?:float|int)\s+\(?&?(\w+)\)?\[", bodies)
    assert set(decls) <= {"v", "m", "o"}, decls
    for word in ("for", "while", "op_info", "opnds", "loo", "__ldg"):
        assert not re.search(rf"\b{word}\b", bodies), word
    with pytest.raises(ValueError):
        cg.generate_source(dec.params, dec.dtype, "block")


# ---------------------------------------------------------------------------
# (e) the kernel library's names
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("unit", list(qk.UNITS))
def test_library_name_follows_sources_and_flags_not_mtime(unit, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(nvcc.CSRC_DIR, csrc)
    name = os.path.basename(qk.unit_path(unit, str(csrc)))
    assert name.startswith(f"lib{unit}_") and name.endswith(".so")
    assert name == os.path.basename(qk.unit_path(unit))
    _, files, _ = qk.UNITS[unit]
    for f in files:
        path = csrc / f
        os.utime(path, (1, 1))  # older than any library: no rebuild follows
        assert os.path.basename(qk.unit_path(unit, str(csrc))) == name
        text = path.read_text()
        path.write_text(text + "\n")
        changed = os.path.basename(qk.unit_path(unit, str(csrc)))
        assert changed != name, f
        path.write_text(text)
        assert os.path.basename(qk.unit_path(unit, str(csrc))) == name
    monkeypatch.setattr(nvcc, "NVCC_FLAGS", nvcc.NVCC_FLAGS + ["-lineinfo"])
    assert os.path.basename(qk.unit_path(unit, str(csrc))) != name
    # the units are built from different sources or flags: no two share a file
    assert len({qk.unit_path(u) for u in qk.UNITS}) == len(qk.UNITS)


# ---------------------------------------------------------------------------
# (f) the block loop end to end
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def peg500(tmp_path_factory):
    g = JaxTanner.from_alist(os.path.join(
        REPO, "codes", "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist"))
    codec = JaxCodec.design(g, 0.90**2, max_iters=8, Nq_Cha=16, Nq_Msg=16)
    return carry(codec, tmp_path_factory.mktemp("blk_loop") / "peg500.npz")


def test_block_loop_equals_std_loop_jax_and_golden(peg500, monkeypatch):
    jcodec, pcodec = peg500
    lc, lm = labels(jcodec, 2.0, 24, 7)
    spec = build_arith_spec(pcodec, dtype=np.int16)
    blocks = ArithLUTDecoder(pcodec, "cpu", spec=spec, loop="blocks")
    std = ArithLUTDecoder(pcodec, "cpu", spec=spec)
    assert blocks.loop == "blocks" and std.loop == "std"
    qk.reset_launches()
    out = blocks(lc, lm)
    assert all(v == 0 for v in qk.LAUNCHES.values())  # the CPU takes the plain versions
    for a, b in zip(out, std(lc, lm)):
        assert torch.equal(a, b)
    monkeypatch.setenv("LUT_LDPC_NO_STD_KERNELS", "1")  # the JAX plain loop
    jd = JaxArith(jcodec, early_exit=True, spec=jax_full_spec(jcodec, dtype=np.int16))
    assert jd._build_std_kernels() is None
    for a, b in zip(out, jd(lc, lm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bits, ok, iters = (o.numpy() for o in out)
    for f in range(4):
        want, it = pcodec.decode_ref(lc[f], lm[f])
        np.testing.assert_array_equal(bits[f], np.asarray(want))
        assert iters[f] == abs(it) and ok[f] == (it > 0)
    assert (iters > 1).any()
