"""Generated VN kernels: one CUDA translation unit per arithmetic spec.

``generate_source`` writes, for the degree classes of a ``VNParams`` (kinds
"qc" and "std"), or ``block_source`` for the block programs of a
per-degree-block loop (kind "block", one class per VN layout block: a
block's tree, its leave-one-out table and ``use_tot``), the straight-line
programs of ``vn_program`` as C++ functions: every step a named
``float``, every operand sum written out left to right, every emission
written out (where the thresholds ascend, every comparison first and then a
bisecting tree of selects over them, each a named ``float``; the plain
select chain otherwise, and in a block program of more than
``BLOCK_TREE_MAX_COMPARES`` comparisons; ``sym`` and tie handling only where
the op has them).
The selects are written flat on purpose: as nested conditional expressions
the compiler turns the bisection into divergent branches with a constant
load in every arm.
Nothing in a body is indexed at run time and nothing of the tree is loaded.
The thresholds and levels stay data: each is read at a literal offset of the
class's slice of the iteration's parameter row, so one binary serves every
iteration of the spec.  The bodies also compile as host C++ (the unit ends
in a small host entry point when it is not compiled by nvcc), which is how the CPU
tests hold them against the plain versions.

The kernels around the bodies are ``csrc/vn_frames.cuh``.  ``start_build``
compiles a unit with nvcc (sm_90a, ``--fmad=false``) into
``build/torch_kernels/libvn_<hash>.so``, named by the sha256 of the text, the
frames and the compiler flags, and reuses the file when it exists;
``library`` gives the unit already started for a ``VNParams`` or starts it,
``block_library`` the same for a set of block programs, and ``block_class``
the unit and class of one block program (the unit of a decoder's set where
one holds it, else a unit of its own).
Several units build side by side: both return at once and
``VNLibrary.handle`` waits, loads, and raises if the compiler failed:
nothing falls back to another kernel.  To force a rebuild delete
``build/torch_kernels/`` or pass ``force=True``.  Inside ``cold_units(d)``
every unit is compiled anew into the directory ``d``, the units built
before left alone (what a first decoder costs, timed without touching
``build/torch_kernels/``).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import torch

from .nvcc import (BUILD_DIR, CSRC_DIR, NVCC_FLAGS, Build, digest, nvcc_path,
                   ptxas_entries)
from .vn_program import CHA, MSG, build_vn_program

__all__ = ["generate_source", "block_source", "source_hash", "start_build",
           "library", "start_block_build", "block_library", "block_class",
           "cold_units", "VNLibrary", "ptxas_by_kernel", "FRAMES_SOURCE", "MAX_CLASS_PARAMS"]

FRAMES_SOURCE = os.path.join(CSRC_DIR, "vn_frames.cuh")
# floats of one class's parameter slice: it travels as a kernel argument
MAX_CLASS_PARAMS = 960
_C_TYPES = {torch.int16: "int16_t", torch.float32: "float"}
KINDS = ("qc", "std", "block")
# A block program's ops keep their plain thresholds (about twice the
# magnitude ones of a spec's symmetric ops).  Written as comparison trees,
# the degree-17 program of the N=64800 PEG code (96 steps, 1440
# comparisons) took 255 registers and spilled on an H100; written as select
# chains it did not.  A program with at most this many comparisons keeps the
# trees, which were the faster form at the lower degrees (degree 9: 600
# comparisons, 126 registers).
BLOCK_TREE_MAX_COMPARES = 1000


# ---------------------------------------------------------------------------
# source text
# ---------------------------------------------------------------------------
def _select_tree(name, lines, lev, lo, hi):
    """Selects that pick lev[number of thresholds reached] among ascending
    thresholds [lo, hi) from the comparisons {name}_c{t}, bottom-up, each a
    named float; returns the expression of the result."""
    if lo == hi:
        return lev(lo)
    mid = (lo + hi) >> 1
    above = _select_tree(name, lines, lev, mid + 1, hi)
    below = _select_tree(name, lines, lev, lo, mid)
    var = f"{name}_l{lo}_{hi}"
    lines.append(f"const float {var} = {name}_c{mid} ? {above} : {below};")
    return var


def _sum(terms):
    total = terms[0]
    for x in terms[1:]:
        total = f"({total} + {x})"
    return total


def _step_lines(name, op, operands, base, total=None, tree=True):
    """C++ statements that define `name` as the emission of `op` for the sum
    of `operands` (names of floats), or for the expression `total` where one
    is given; parameter offsets relative to `base`.  Ascending thresholds
    are bisected by a tree of selects where `tree`, else (and for unsorted
    thresholds) the select chain is written out."""
    o = op.off - base
    thr = lambda t: f"P.v[{o + t}]"
    lev = lambda t: f"P.v[{o + op.nthr + t}]"
    s = f"{name}_s"
    lines = [f"const float {s} = {total or _sum(operands)};"]
    x = s
    if op.sym:
        x = f"{name}_x"
        lines.append(f"const float {x} = fabsf({s});")
    stages = ["e"] + (["g"] if op.sym else []) + (["t"] if op.has_tie else [])
    var = {st: name if st == stages[-1] else f"{name}_{st}" for st in stages}
    if (op.sorted_thr and tree) or op.nthr == 0:
        lines += [f"const bool {name}_c{t} = {x} >= {thr(t)};" for t in range(op.nthr)]
        root = _select_tree(name, lines, lev, 0, op.nthr)
        lines.append(f"const float {var['e']} = {root};")
    else:
        lines.append(f"float {var['e']} = {lev(0)};")
        lines += [f"{var['e']} = {x} >= {thr(t)} ? {lev(t + 1)} : {var['e']};"
                  for t in range(op.nthr)]
    if op.sym:
        lines.append(f"const float {var['g']} = {s} < 0.f ? -{var['e']} : {var['e']};")
    if op.has_tie:
        prev = var["g" if op.sym else "e"]
        lines.append(f"const float {var['t']} = {s} == 0.f ? ({operands[-1]} < 0.f ? "
                     f"{lev(op.nthr + 1)} : {lev(op.nthr + 2)}) : {prev};")
    return lines


def _class_slice(ops):
    """(offset, length) of the ops' parameters in a parameter row."""
    if not ops:
        return 0, 0
    lo = min(op.off for op in ops)
    hi = max(op.off + 2 * op.nthr + 3 for op in ops)
    return lo, hi - lo


def _class_source(c, prog, kind):
    d = prog.degree
    tree = (kind != "block" or sum(prog.ops[st.op].nthr for st in prog.steps)
            <= BLOCK_TREE_MAX_COMPARES)
    base, length = _class_slice(prog.ops)
    if length > MAX_CLASS_PARAMS:
        raise ValueError(f"VN class of degree {d}: {length} parameters > "
                         f"{MAX_CLASS_PARAMS} (a kernel argument holds them)")

    def ref(r):
        if r[0] == MSG:
            return f"m{r[1]}"
        return "ch" if r[0] == CHA else prog.steps[r[1]].name

    args = ", ".join([f"float m{k}" for k in range(d)] + ["float ch"]
                     + [f"float& o{k}" for k in range(d)])
    out = [f"// class {c}: degree {d}, {len(prog.ops)} ops, {len(prog.steps)} steps",
           f"struct VnPrm{c} {{ float v[{max(length, 1)}]; }};",
           f"LUT_VN_FN void vn_class_{c}(const VnPrm{c}& P, {args}) {{"]
    if any(st.minus for st in prog.steps):
        out.append(f"  const float tot = {_sum([f'm{k}' for k in range(d)])};")
    for st in prog.steps:
        operands = [ref(r) for r in st.operands]
        total = f"(tot - {ref(st.minus)})" if st.minus else None
        out.append(f"  // {st.name}: op {st.op} of "
                   + (total if total else f"({', '.join(operands)})"))
        out += ["  " + ln for ln in _step_lines(st.name, prog.ops[st.op], operands,
                                                base, total, tree)]
    out += [f"  o{k} = {ref(r)};" for k, r in enumerate(prog.outputs)]
    out.append("  (void)P;")
    out += [f"  (void)m{k};" for k in range(d)]
    call = ", ".join(["P"] + [f"m[{k}]" for k in range(d)] + ["ch"]
                     + [f"o[{k}]" for k in range(d)])
    out += ["}",
            f"template <> struct VnClass<{c}> {{",
            f"  static constexpr int D = {d}, OFF = {base}, LEN = {length};",
            f"  typedef VnPrm{c} Prm;",
            f"  static LUT_VN_FN void run(const Prm& P, const float (&m)[{d}], float ch,",
            f"                            float (&o)[{d}]) {{",
            f"    vn_class_{c}({call});",
            "  }",
            "};", ""]
    return out


_PRELUDE = """\
// VN class bodies of one arithmetic spec, written by
// lut_ldpc_torch/decoder/vn_codegen.py from the spec's tree structure: do not
// edit.  Per class C: vn_class_C, the leave-one-out threshold tree as
// straight-line float code (identity sweep iK, shifted sweep sK, ops
// re-evaluated for output I tI_K), and VnClass<C>, which hands it to the
// kernel frames.  P.v holds the class's slice of one iteration's parameter
// row: per op its thresholds, levels, tie_lo, tie_hi.
#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define LUT_VN_FN __device__ __forceinline__
#else
#define LUT_VN_FN inline
#endif

template <int C> struct VnClass;
"""

_HOST_ENTRY = """\
// Host build: class `cls` on n nodes, msg and out (D, n) row-major, prm_row
// one iteration's parameter row.
extern "C" int lut_vn_host_eval(int cls, const float* prm_row, const float* msg,
                                const float* ch, float* out, int n) {
  switch (cls) {
#define LUT_VN_CASE(C)                                                 \\
  case C: {                                                            \\
    typedef VnClass<C> K;                                              \\
    K::Prm P;                                                          \\
    memcpy(P.v, prm_row + K::OFF, K::LEN * sizeof(float));             \\
    for (int j = 0; j < n; ++j) {                                      \\
      float m[K::D], o[K::D];                                          \\
      for (int k = 0; k < K::D; ++k) m[k] = msg[k * n + j];            \\
      K::run(P, m, ch[j], o);                                          \\
      for (int k = 0; k < K::D; ++k) out[k * n + j] = o[k];            \\
    }                                                                  \\
    return 0;                                                          \\
  }
    LUT_VN_FOR_CLASSES(LUT_VN_CASE)
#undef LUT_VN_CASE
  }
  return -1;
}
"""


def _unit_source(programs, dtype, kind: str) -> str:
    """The translation unit of `programs` (one VNProgram per class) for
    messages stored as `dtype` (torch.int16 or torch.float32) and the frames
    of `kind`."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: expected one of {KINDS}")
    out = [_PRELUDE]
    for c, prog in enumerate(programs):
        out += _class_source(c, prog, kind)
    out += ["#define LUT_VN_FOR_CLASSES(X) "
            + " ".join(f"X({c})" for c in range(len(programs))),
            f"typedef {_C_TYPES[dtype]} LutVnT;  // message storage type",
            f"#define LUT_VN_{kind.upper()} 1",
            "",
            "#ifdef __CUDACC__",
            '#include "vn_frames.cuh"',
            "#else",
            _HOST_ENTRY + "#endif"]
    return "\n".join(out) + "\n"


def generate_source(params, dtype, kind: str) -> str:
    """The translation unit of the first `params.kernel_classes` classes of
    `params` for messages stored as `dtype` and the frames of `kind` ("qc":
    circulant rows, "std": slot planes)."""
    if kind == "block":
        raise ValueError("a block unit is made of block programs: block_source")
    return _unit_source([build_vn_program(c)
                         for c in params.classes[: params.kernel_classes]],
                        dtype, kind)


def block_source(progs, dtype) -> str:
    """The translation unit of the block programs `progs`
    (``block_kernels.VNBlockProgram``, one class each, in order) for
    messages stored as `dtype`, in the block frames."""
    return _unit_source([p.program for p in progs], dtype, "block")


def source_hash(text: str) -> str:
    """sha256 over the generated text, the frames and the compiler flags."""
    with open(FRAMES_SOURCE, "rb") as f:
        frames = f.read()
    return digest((text.encode(), frames, " ".join(NVCC_FLAGS).encode()))


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------
def ptxas_by_kernel(report: str) -> list:
    """Per kernel instantiation of a unit's ptxas -v report: dict(kernel,
    cls, vec, registers, stack, spill_stores, spill_loads)."""
    out = []
    for r in ptxas_entries(report,
                           r"(vn_(?:qc|std|block)_class_kernel)I[sf]Li(\d+)ELi(\d+)E"):
        kernel, cls, vec = r.pop("groups")
        out.append(dict(kernel=kernel, cls=int(cls), vec=int(vec), **r))
    return sorted(out, key=lambda r: (r["kernel"], r["cls"], r["vec"]))


class VNLibrary:
    """One generated unit: its build (a running nvcc or a finished one) and,
    once loaded, its entry points.  seconds: what the compiler took (0.0 when
    the file was there); report: its ptxas -v output."""

    def __init__(self, text: str, force: bool = False):
        self.text = text
        self.hash = source_hash(text)
        path = os.path.join(BUILD_DIR, f"libvn_{self.hash[:16]}.so")
        self.source_path = os.path.join(BUILD_DIR, f"vn_{self.hash[:16]}.cu")
        if force or not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(self.source_path, "w") as f:
                f.write(text)
        self._build = Build(path, self.source_path, force=force, nvcc=nvcc_path)
        self.path = path
        self._lib = None
        self._lock = threading.Lock()

    @property
    def seconds(self) -> float:
        return self._build.seconds

    @property
    def report(self) -> str:
        return self._build.report

    def handle(self):
        """The loaded library; waits for the compiler and raises if it
        failed."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self._build.wait())
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.lut_vn_vec.argtypes = [i, i, i]
                lib.lut_vn_vec.restype = i
                if hasattr(lib, "lut_vn_qc_class"):
                    lib.lut_vn_qc_class.argtypes = [i] + [p] * 9 + [i] * 6 + [p, p]
                    lib.lut_vn_qc_class.restype = i
                if hasattr(lib, "lut_vn_std_class"):
                    lib.lut_vn_std_class.argtypes = [i] + [p] * 5 + [i] * 6 + [p, p]
                    lib.lut_vn_std_class.restype = i
                if hasattr(lib, "lut_vn_block_class"):
                    lib.lut_vn_block_class.argtypes = [i] + [p] * 6 + [i] * 6 + [p, p]
                    lib.lut_vn_block_class.restype = i
                self._lib = lib
            return self._lib


_libs: dict = {}  # (params.tree_key, dtype, kind) -> VNLibrary
_libs_lock = threading.Lock()


def start_build(params, dtype, kind: str, force: bool = False) -> VNLibrary:
    """The unit of (params, dtype, kind), its compiler started if the library
    file is missing (or `force`).  Returns without waiting; params of one
    tree structure share one object."""
    key = (params.tree_key, dtype, kind)
    with _libs_lock:
        if force or key not in _libs:
            _libs[key] = VNLibrary(generate_source(params, dtype, kind), force)
        return _libs[key]


def library(params, dtype, kind: str) -> VNLibrary:
    """The unit of `params`, its build started if need be; ``handle()`` of
    the result waits for the build and loads it."""
    lib = _libs.get((params.tree_key, dtype, kind))
    return lib if lib is not None else start_build(params, dtype, kind)


# (program key, dtype) -> (VNLibrary, class) of every block program in a unit
_block_classes: dict = {}


def start_block_build(progs, dtype, force: bool = False) -> VNLibrary:
    """The unit of the block programs `progs` (class c: progs[c]), its
    compiler started if the library file is missing (or `force`); returns
    without waiting."""
    key = (tuple(p.key for p in progs), dtype, "block")
    with _libs_lock:
        if force or key not in _libs:
            _libs[key] = VNLibrary(block_source(progs, dtype), force)
            for c, p in enumerate(progs):
                _block_classes[p.key, dtype] = (_libs[key], c)
        return _libs[key]


def block_library(progs, dtype) -> VNLibrary:
    """The unit of `progs`, its build started if need be."""
    lib = _libs.get((tuple(p.key for p in progs), dtype, "block"))
    return lib if lib is not None else start_block_build(progs, dtype)


@contextlib.contextmanager
def cold_units(build_dir: str):
    """Inside the block every unit that is asked for is compiled into
    `build_dir` (an empty directory) and loaded from there; the units
    started before are neither used nor replaced, and are the ones found
    again after the block.  Yields the block's own unit table."""
    global BUILD_DIR, _libs, _block_classes
    saved = BUILD_DIR, _libs, _block_classes
    with _libs_lock:
        BUILD_DIR, _libs, _block_classes = build_dir, {}, {}
    try:
        yield _libs
    finally:
        with _libs_lock:
            BUILD_DIR, _libs, _block_classes = saved


def block_class(prog, dtype) -> tuple:
    """(VNLibrary, class index) of the block program `prog`: the unit that
    holds it, or a unit of `prog` alone, started here."""
    found = _block_classes.get((prog.key, dtype))
    return found if found is not None else (start_block_build([prog], dtype), 0)
