"""CN and VN passes of the value-domain decode.

``cn_qc_pass`` / ``vn_qc_pass`` (quasi-cyclic graphs) and ``cn_std_pass`` /
``vn_std_pass`` (graphs without circulant structure) take CUDA tensors to
hand-written Hopper kernels and CPU tensors to their plain-torch twins
``*_ref``, which sit beside them and compute the same values.  A CUDA tensor
never falls back to a twin: the kernel launches or the wrapper raises.

They replace lut_ldpc_tpu/decoder/qc_kernels.py::cn_qc_pass (:549),
::vn_qc_pass (:873), ::cn_std_pass (:1206) and ::vn_std_pass (:1353),
computing what those compute on the standard slot-major grouped layout (no
halo planes, no tile schedule): messages (rows, B), frame axis contiguous.
On a QC graph every circulant shift is a modular row index in the load; on
a std graph each degree class is a run of contiguous slot planes.  The std
CN pass reads the VN-grouped v2c array and writes the VN-grouped c2v array:
the two row gathers between the groupings (``jnp.take`` around the JAX
kernel) live inside its loads and stores, so the std VN pass takes its
output as it is.

The CN passes launch the frames of ``csrc/cn_frames.cuh`` (one instantiation
per check degree, several frames a thread, one check a block; one launch per
run of block-rows of one degree or per degree class).  The VN passes launch
kernels generated for the decoder's arithmetic spec (``vn_codegen``: the
class trees as straight-line code in the frames of ``csrc/vn_frames.cuh``,
one launch per degree class).  The table-driven ``cn_*_kernel`` /
``vn_*_kernel`` of ``csrc/qc_kernels.cu``, one binary for every codec, run
only when a caller passes ``generic=True`` (a second witness and the time
to compare with); the std CN witness gathers in torch around its kernel.

The kernel library is four units, compiled with nvcc side by side at first
use into ``build/torch_kernels/`` (shared libraries with a plain C
interface, loaded with ctypes, launched on the current stream): the CN
frames of ``cn_frames.cu`` once for int16 and once for float32 messages,
``qc_kernels.cu``, the table-driven witnesses and the CN block kernel
(wrappers in ``block_kernels``), and ``loop_glue.cu``, the value-domain
loop's state, latch and init kernels (wrappers in ``loop_glue``).  Each
file is named by a sha256 over the text of its sources and the compiler flags
(``nvcc.library_name``), so a library on disk is never stale.
``LAUNCHES`` counts each wrapper's calls that launched a kernel (passes);
``CLASS_LAUNCHES`` the launches of the per-degree kernels these made, one
for each call of a per-degree entry point that returned 0 (an entry point
with nothing to launch returns ``NOTHING_TO_LAUNCH``, which counts none).
``ONE_FRAME_LAUNCHES`` counts those class launches of the CN frames and the
generated QC and std VN kernels that ran at one frame a thread (a batch
width or an array start that the vector path does not take).
``WITNESS_LAUNCHES`` counts the passes that went through a table-driven
witness (``generic=True``).  ``PLAIN_RUNS`` counts the wrappers' calls on
CPU tensors, which run the plain versions.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import nvcc, vn_codegen
from .params import QCTables, StdTables, VNParams

__all__ = ["cn_qc_pass", "vn_qc_pass", "cn_qc_pass_ref", "vn_qc_pass_ref",
           "cn_std_pass", "vn_std_pass", "cn_std_pass_ref", "vn_std_pass_ref",
           "build_kernels", "start_builds", "unit_path", "ptxas_cn_frames",
           "LAUNCHES", "LAUNCHES_BY_DTYPE", "CLASS_LAUNCHES", "ONE_FRAME_LAUNCHES",
           "WITNESS_LAUNCHES", "PLAIN_RUNS",
           "NOTHING_TO_LAUNCH",
           "reset_launches", "UNITS", "KERNEL_SOURCE", "CN_SOURCE"]

KERNEL_SOURCE = "qc_kernels.cu"  # the CN block kernel and the table-driven witnesses
CN_SOURCE = "cn_frames.cuh"      # the CN frames, compiled through cn_frames.cu
GLUE_SOURCE = "loop_glue.cu"     # the loop's state, latch and init kernels
# unit -> (the file nvcc compiles, every file of the unit, extra flags);
# files in csrc/
UNITS = {
    "qc_kernels": (KERNEL_SOURCE, (KERNEL_SOURCE,), ()),
    "cn_frames_int16": ("cn_frames.cu", ("cn_frames.cu", CN_SOURCE, "cn_frame.h"),
                        ("-DLUT_CN_STORAGE=int16_t",)),
    "cn_frames_float32": ("cn_frames.cu", ("cn_frames.cu", CN_SOURCE, "cn_frame.h"),
                          ("-DLUT_CN_STORAGE=float",)),
    # the value-domain loop's glue (wrappers in loop_glue.py)
    "loop_glue": (GLUE_SOURCE, (GLUE_SOURCE,), ()),
}
MAX_DEGREE = 32  # widest row table the kernels are instantiated for
MAX_CN_DEGREE = 40  # widest check of the CN frames (kMaxDegree in cn_frame.h)
MAX_TREE_OPS = 32  # ops of one VN tree (kMaxOps in the source)
NOTHING_TO_LAUNCH = -1  # kNothingToLaunch of the CN and VN frames

# kernel launches per wrapper, and the same split by message dtype
LAUNCHES = {"cn_qc_pass": 0, "vn_qc_pass": 0, "cn_std_pass": 0,
            "vn_std_pass": 0, "cn_block_pass": 0, "vn_block_pass": 0}
LAUNCHES_BY_DTYPE = {(name, dt): 0 for name in LAUNCHES
                     for dt in ("int16", "float32")}
# launches of the per-degree kernels (CN frames, generated VN kernels,
# the CN block kernel; several a pass); a pass through a table-driven
# witness adds nothing here
CLASS_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
# of those, the launches at one frame a thread (CN frames, generated QC and
# std VN kernels)
ONE_FRAME_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
# passes through a table-driven witness (generic=True)
WITNESS_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
# wrapper calls on CPU tensors (the plain versions ran)
PLAIN_RUNS = dict.fromkeys(LAUNCHES, 0)

_lock = threading.Lock()
_builds: dict = {}  # unit -> nvcc.Build
_libs: dict = {}    # unit -> loaded library


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_DTYPE, CLASS_LAUNCHES, ONE_FRAME_LAUNCHES,
                   WITNESS_LAUNCHES, PLAIN_RUNS):
        for k in counts:
            counts[k] = 0


def _launched(name: str, dtype: torch.dtype) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_DTYPE[name, str(dtype).removeprefix("torch.")] += 1


def unit_path(unit: str, csrc: str | None = None) -> str:
    """The library file of `unit`, named by the text of its sources (in
    `csrc`, the package's csrc/ by default) and the compiler flags."""
    csrc = csrc or nvcc.CSRC_DIR
    _, files, flags = UNITS[unit]
    return os.path.join(nvcc.BUILD_DIR, nvcc.library_name(
        unit, [os.path.join(csrc, f) for f in files], flags))


def start_builds(force: bool = False) -> dict:
    """Every unit's build, started side by side where its file is missing
    (or `force`); returns without waiting."""
    with _lock:
        for unit, (source, _, flags) in UNITS.items():
            if force or unit not in _builds:
                _builds[unit] = nvcc.Build(unit_path(unit),
                                           os.path.join(nvcc.CSRC_DIR, source),
                                           flags, force)
                _libs.pop(unit, None)
        return dict(_builds)


def build_kernels(force: bool = False) -> dict:
    """Build the kernel library's units side by side, each where its file is
    missing (or `force`), and wait for them; returns unit -> nvcc.Build
    (path, seconds spent compiling, ptxas -v report).  Raises if nvcc
    failed."""
    builds = start_builds(force)
    for b in builds.values():
        b.wait()
    return builds


def ptxas_cn_frames(report: str) -> list:
    """Per CN frame instantiation of the library's ptxas -v report:
    dict(kernel, dtype, width (the check degree, or a bucket above
    lutcn::kExact), vec (frames a thread), registers, stack, spill_stores,
    spill_loads)."""
    out = []
    for r in nvcc.ptxas_entries(report, r"(cn_(?:qc|std)_frames_kernel)I([sf])Li(\d+)ELi(\d+)E"):
        kernel, t, w, v = r.pop("groups")
        out.append(dict(kernel=kernel, dtype="int16" if t == "s" else "float32",
                        width=int(w), vec=int(v), **r))
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int
_CN_FRAMES = {"lut_cn_width": [_I], "lut_cn_vec": [_I] * 4,
              "lut_cn_qc_frames": [_I] + [_P] * 6 + [_I] * 7 + [_P],
              "lut_cn_std_frames": [_I] + [_P] * 4 + [_I] * 6 + [_P]}
# unit -> entry point -> argument types (every entry point returns an int)
_SIGNATURES = {
    "qc_kernels": {
        "lut_cn_qc_pass": [_I] + [_P] * 7 + [_I] * 4 + [_P],
        "lut_vn_qc_pass": [_I] + [_P] * 16 + [_I] * 6 + [_P],
        "lut_cn_std_pass": [_I] + [_P] * 4 + [_I] * 4 + [_P],
        "lut_vn_std_pass": [_I] + [_P] * 6 + [_I] + [_P] * 5 + [_I] * 5 + [_P],
        # the CN block kernel and the VN block witness (wrappers in
        # block_kernels.py)
        "lut_cn_block_pass": [_I] + [_P] * 3 + [_I] * 4 + [_P],
        "lut_vn_block_pass": [_I] + [_P] * 9 + [_I] * 8 + [_P]},
    "cn_frames_int16": _CN_FRAMES,
    "cn_frames_float32": _CN_FRAMES,
    "loop_glue": {"lut_loop_state": [_P] * 6 + [_I] * 3 + [_P],
                  "lut_latch": [_P] * 3 + [_I] * 2 + [_P],
                  "lut_init_values": [_I] * 2 + [_P] * 4 + [_I, _P, _I, _P, _P,
                                                            ctypes.c_float] + [_I] * 3 + [_P]},
}


def _unit(unit: str):
    """The loaded library of `unit`; a first call starts every unit's build
    and waits for this one's."""
    lib = _libs.get(unit)
    if lib is not None:
        return lib
    path = start_builds()[unit].wait()
    with _lock:
        if unit not in _libs:
            lib = ctypes.CDLL(path)
            for name, args in _SIGNATURES[unit].items():
                getattr(lib, name).argtypes = args
                getattr(lib, name).restype = _I
            _libs[unit] = lib
        return _libs[unit]


def _load():
    """The CN block kernel and the table-driven witnesses."""
    return _unit("qc_kernels")


def _load_cn(is_f32: int):
    """The CN frames of one message storage type."""
    return _unit("cn_frames_float32" if is_f32 else "cn_frames_int16")


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_msgs(m, rows, device):
    if m.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"messages: dtype {m.dtype}, expected int16 or float32")
    if m.dim() != 2 or m.shape[0] != rows:
        raise ValueError(f"messages: shape {tuple(m.shape)}, expected ({rows}, B)")
    _check("messages", m, m.dtype, m.shape, device)


def _check_grid(nodes, B):
    if nodes * -(-B // 256) >= 2**31:
        raise ValueError("grid too large for one launch")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _class_launched(err: int, name: str, one_frame: bool = False) -> None:
    """After a call of a per-degree entry point (CN or VN frames): raise on a
    CUDA error; count one class launch of `name` where the kernel was
    launched (and one at one frame a thread where `one_frame`), none where
    there was nothing to launch."""
    if err == NOTHING_TO_LAUNCH:
        return
    _raise_on(err, name)
    CLASS_LAUNCHES[name] += 1
    ONE_FRAME_LAUNCHES[name] += one_frame


# ---------------------------------------------------------------------------
# CN pass
# ---------------------------------------------------------------------------
def _cn_compute(x: torch.Tensor):
    """Min-LUT CN update of x (d, n, B) in float32: (outputs (d, n, B)
    float32, parity of the input signs (n, B) bool).  Every slot whose
    magnitude equals min1 sees min2 (the kernels' form)."""
    x = x.to(torch.float32)
    neg = x < 0
    mag = x.abs()
    par = neg[0].clone()
    min1 = mag[0].clone()
    min2 = torch.full_like(min1, float("inf"))
    for k in range(1, x.shape[0]):
        par ^= neg[k]
        min2 = torch.minimum(min2, torch.maximum(min1, mag[k]))
        min1 = torch.minimum(min1, mag[k])
    tmp = torch.where(mag == min1, min2, min1)
    return torch.where(par ^ neg, -tmp, tmp), par


def cn_qc_pass_ref(m_vn: torch.Tensor, tables: QCTables):
    """Plain-torch twin of the CN kernel: m_vn (rows_vn, B) -> (m_cn
    (rows_cn, B) same dtype, synd_ok (B,) bool).  Padding rows of m_cn are
    left unwritten (uninitialized), as in the kernel."""
    B = m_vn.shape[1]
    m_cn = torch.empty((tables.rows_cn, B), dtype=m_vn.dtype, device=m_vn.device)
    synd = torch.ones(B, dtype=torch.bool, device=m_vn.device)
    for src, dst in tables.cn_plain:
        x = m_vn[src.reshape(-1)].reshape(*src.shape, B)
        out, par = _cn_compute(x)
        m_cn[dst.reshape(-1)] = out.reshape(-1, B).to(m_vn.dtype)
        synd &= ~par.any(dim=0)
    return m_cn, synd


def _check_cn_degree(max_dc: int, generic: bool) -> None:
    """The CN frames take checks up to MAX_CN_DEGREE, the table-driven
    witness up to MAX_DEGREE."""
    limit = MAX_DEGREE if generic else MAX_CN_DEGREE
    if max_dc > limit:
        raise ValueError(f"check degree {max_dc} > {limit}")


def cn_qc_pass(m_vn: torch.Tensor, tables: QCTables, generic: bool = False):
    """CN pass: v2c circulant rolls, min-LUT two-min and sign-parity update,
    per-frame syndrome of the input signs.  CUDA tensors launch the CN
    frames, one launch per run of block-rows of one check degree (replaces
    lut_ldpc_tpu/decoder/qc_kernels.py::cn_qc_pass), or with generic=True
    the table-driven kernel; CPU tensors run cn_qc_pass_ref."""
    dev = m_vn.device
    _check_msgs(m_vn, tables.rows_vn, tables.cn_src.device)
    if dev.type == "cpu":
        PLAIN_RUNS["cn_qc_pass"] += 1
        return cn_qc_pass_ref(m_vn, tables)
    B = m_vn.shape[1]
    _check_cn_degree(tables.max_dc, generic)
    R = tables.cn_src.shape[0]
    _check_grid(R * tables.Z, B)
    m_cn = torch.empty((tables.rows_cn, B), dtype=m_vn.dtype, device=dev)
    synd = torch.ones(B, dtype=torch.bool, device=dev)
    is_f32, stream = int(m_vn.dtype == torch.float32), _stream(dev)
    if generic:
        err = _load().lut_cn_qc_pass(
            is_f32, m_vn.data_ptr(), m_cn.data_ptr(), synd.data_ptr(),
            tables.cn_src.data_ptr(), tables.cn_shift.data_ptr(),
            tables.cn_dst.data_ptr(), tables.cn_deg.data_ptr(), R, tables.Z,
            tables.max_dc, B, stream)
        _raise_on(err, "cn_qc_pass")
        WITNESS_LAUNCHES["cn_qc_pass"] += 1
    else:
        lib, aligned = _load_cn(is_f32), _aligned(m_vn, m_cn)
        for lo, hi, d in tables.cn_runs:
            err = lib.lut_cn_qc_frames(
                is_f32, m_vn.data_ptr(), m_cn.data_ptr(), synd.data_ptr(),
                tables.cn_src.data_ptr(), tables.cn_shift.data_ptr(),
                tables.cn_dst.data_ptr(), lo, hi - lo, tables.Z, tables.max_dc, d, B,
                aligned, stream)
            _class_launched(err, "cn_qc_pass", lib.lut_cn_vec(is_f32, d, B, aligned) == 1)
    _launched("cn_qc_pass", m_vn.dtype)
    return m_cn, synd


# ---------------------------------------------------------------------------
# VN pass
# ---------------------------------------------------------------------------
def _emit(s, prm, op):
    """One op's select-chain emission in float32 (prm: the iteration's
    parameter row)."""
    thr = prm[op.off : op.off + op.nthr]
    lev = prm[op.off + op.nthr : op.off + 2 * op.nthr + 1]
    x = s.abs() if op.sym else s
    out = lev[0].expand_as(s)
    for t in range(op.nthr):
        out = torch.where(x >= thr[t], lev[t + 1], out)
    if op.sym:
        out = torch.where(s < 0, -out, out)
    return out


def eval_vn_tree(cls, leaves, prm):
    """Root output of one VN class tree; leaves: list of float32 tensors in
    DFS order (d - 1 messages, then the channel)."""
    vals = list(leaves)
    for op in cls.ops:
        s = vals[op.operands[0]]
        for sl in op.operands[1:]:
            s = s + vals[sl]
        out = _emit(s, prm, op)
        if op.has_tie:
            tlo = prm[op.off + 2 * op.nthr + 1]
            thi = prm[op.off + 2 * op.nthr + 2]
            tie = torch.where(vals[op.operands[-1]] < 0, tlo, thi)
            out = torch.where(s == 0, tie, out)
        vals.append(out)
    return vals[-1]


def _vn_compute(cls, msg, ch, prm):
    """The d leave-one-out outputs of one class: msg (d, n, B), ch (n, B),
    prm the iteration's parameter row -> (list of d (n, B) float32 outputs,
    sign of output 0, agreement of all output signs or None for d == 1)."""
    msg = msg.to(torch.float32)
    ch = ch.to(torch.float32)
    d = cls.degree
    outs, neg0, agree = [], None, None
    for i in range(d):
        leaves = [msg[j] if j < i else msg[j + 1] for j in range(d - 1)]
        out = eval_vn_tree(cls, leaves + [ch], prm)
        outs.append(out)
        ni = out < 0
        if neg0 is None:
            neg0 = ni
        else:
            agree = (ni == neg0) if agree is None else agree & (ni == neg0)
    return outs, neg0, agree


def vn_qc_pass_ref(m_cn: torch.Tensor, cha: torch.Tensor, it: int,
                   params: VNParams, tables: QCTables):
    """Plain-torch twin of the VN kernel: m_cn (rows_cn, B), cha
    (nvar_pad, B) channel values -> (m_vn (rows_vn, B), bits (nvar_pad, B)
    int8, unan (B,) bool).  Rows not covered by a circulant are left
    unwritten, as in the kernel."""
    B = m_cn.shape[1]
    dev = m_cn.device
    m_vn = torch.empty((tables.rows_vn, B), dtype=m_cn.dtype, device=dev)
    bits = torch.empty((tables.nvar_pad, B), dtype=torch.int8, device=dev)
    unan = torch.ones(B, dtype=torch.bool, device=dev)
    prm = params.prm[it]
    for ci, src, dst, node in tables.vn_plain:
        cls = params.classes[ci]
        msg = m_cn[src.reshape(-1)].reshape(cls.degree, -1, B)
        outs, neg0, agree = _vn_compute(cls, msg, cha[node], prm)
        for i, out in enumerate(outs):
            m_vn[dst[i]] = out.to(m_cn.dtype)
        bits[node] = neg0.to(torch.int8)
        if agree is not None:
            unan &= agree.all(dim=0)
    return m_vn, bits, unan


def _check_vn_limits(params: VNParams, max_dv: int, dev) -> None:
    """What the VN kernels are instantiated for: a wider degree or a deeper
    tree raises (the kernel would otherwise overrun its value arrays)."""
    if max_dv > MAX_DEGREE:
        raise ValueError(f"variable degree {max_dv} > {MAX_DEGREE}")
    if params.max_ops > MAX_TREE_OPS:
        raise ValueError(f"VN tree of {params.max_ops} ops > {MAX_TREE_OPS}")
    if params.prm.device != dev:
        raise ValueError(f"params on {params.prm.device}, expected {dev}")


def _aligned(*tensors) -> int:
    """1 when every array starts on a 16-byte boundary (vector accesses)."""
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def _prm_row(params: VNParams, it: int) -> int:
    """Host address of iteration `it`'s parameter row."""
    row = params.prm_host
    return row.ctypes.data + int(it) * row.strides[0]


def vn_qc_pass(m_cn: torch.Tensor, cha: torch.Tensor, it: int,
               params: VNParams, tables: QCTables, generic: bool = False):
    """VN pass for iteration `it`: c2v circulant rolls, per-class
    leave-one-out threshold trees, hard bits and per-frame sign unanimity.
    CUDA tensors launch the kernels generated for the spec, one launch per
    run of block-rows of one class (replaces
    lut_ldpc_tpu/decoder/qc_kernels.py::vn_qc_pass), or with generic=True
    the table-driven kernel; CPU tensors run vn_qc_pass_ref."""
    dev = m_cn.device
    _check_msgs(m_cn, tables.rows_cn, tables.vn_src.device)
    B = m_cn.shape[1]
    _check("cha", cha, m_cn.dtype, (tables.nvar_pad, B), dev)
    if not 0 <= it < params.num_iters:
        raise IndexError(f"iteration {it} outside the spec's {params.num_iters}")
    if dev.type == "cpu":
        PLAIN_RUNS["vn_qc_pass"] += 1
        return vn_qc_pass_ref(m_cn, cha, it, params, tables)
    R = tables.vn_src.shape[0]
    _check_grid(R * tables.Z, B)
    m_vn = torch.empty((tables.rows_vn, B), dtype=m_cn.dtype, device=dev)
    bits = torch.empty((tables.nvar_pad, B), dtype=torch.int8, device=dev)
    unan = torch.ones(B, dtype=torch.bool, device=dev)
    if generic:
        _check_vn_limits(params, tables.max_dv, dev)
        err = _load().lut_vn_qc_pass(
            int(m_cn.dtype == torch.float32), m_cn.data_ptr(), cha.data_ptr(),
            m_vn.data_ptr(), bits.data_ptr(), unan.data_ptr(),
            tables.vn_src.data_ptr(), tables.vn_shift.data_ptr(),
            tables.vn_dst.data_ptr(), tables.vn_node.data_ptr(),
            tables.vn_cls.data_ptr(), params.cls_deg.data_ptr(),
            params.cls_op0.data_ptr(), params.cls_nops.data_ptr(),
            params.op_info.data_ptr(), params.opnds.data_ptr(),
            params.prm.data_ptr(), int(it), params.prm.shape[1], R, tables.Z,
            tables.max_dv, B, _stream(dev))
        _raise_on(err, "vn_qc_pass")
        WITNESS_LAUNCHES["vn_qc_pass"] += 1
    else:
        lib = vn_codegen.library(params, m_cn.dtype, "qc").handle()
        aligned = _aligned(m_cn, cha, m_vn, bits)
        row, stream = _prm_row(params, it), _stream(dev)
        for lo, hi, ci in tables.vn_runs:
            err = lib.lut_vn_qc_class(
                ci, m_cn.data_ptr(), cha.data_ptr(), m_vn.data_ptr(), bits.data_ptr(),
                unan.data_ptr(), tables.vn_src.data_ptr(), tables.vn_shift.data_ptr(),
                tables.vn_dst.data_ptr(), tables.vn_node.data_ptr(), lo, hi - lo, tables.Z,
                tables.max_dv, B, aligned, row, stream)
            _class_launched(err, "vn_qc_pass", lib.lut_vn_vec(ci, B, aligned) == 1)
    _launched("vn_qc_pass", m_cn.dtype)
    return m_vn, bits, unan


# ---------------------------------------------------------------------------
# std layout (graphs without circulant structure)
# ---------------------------------------------------------------------------
def _planes(m, blk, B):
    """The real rows of a class's slot planes: (d, num_nodes, B) view."""
    d, n, e0 = blk.degree, blk.n_pad, blk.edge_start
    return m[e0 : e0 + n * d].reshape(d, n, B)[:, : blk.num_nodes]


def _cn_planes_ref(m_cn: torch.Tensor, tables: StdTables):
    """The two-min of every real check on the CN-grouped slot planes:
    (outputs in the same layout, padding rows unwritten, synd_ok (B,))."""
    B = m_cn.shape[1]
    out = torch.empty_like(m_cn)
    synd = torch.ones(B, dtype=torch.bool, device=m_cn.device)
    for blk in tables.cn_blocks:
        o, par = _cn_compute(_planes(m_cn, blk, B))
        _planes(out, blk, B).copy_(o.to(m_cn.dtype))
        synd &= ~par.any(dim=0)
    return out, synd


def cn_std_pass_ref(m_vn: torch.Tensor, tables: StdTables):
    """Plain-torch twin of the std CN pass: m_vn (rows_vn, B) VN-grouped
    v2c values -> (VN-grouped c2v values, synd_ok (B,) bool).  What the JAX
    std loop does around its kernel: the gather by perm_v2c, the two-min per
    degree class on the CN-grouped slot planes, the gather by perm_c2v on the
    real rows.  Padding checks take no part in the syndrome; rows of padding
    variables are left unwritten, as in the kernel."""
    out_cn, synd = _cn_planes_ref(m_vn.index_select(0, tables.perm_v2c), tables)
    out = torch.empty_like(m_vn)
    real = tables.vn_real
    out[real] = out_cn.index_select(0, tables.perm_c2v[real])
    return out, synd


def _cn_std_frames(m_in, out, synd, tables: StdTables, rows) -> None:
    """The CN frames over every degree class, one launch each: check slot e
    (a CN-grouped edge row) is read from m_in and written to out at row
    rows[e].  cn_std_pass passes tables.inv_c2v (the VN-grouped arrays);
    lut_ldpc_torch.profile_cn an identity table (the CN-grouped planes, for
    the unfolded route it times)."""
    is_f32, aligned = int(m_in.dtype == torch.float32), _aligned(m_in, out)
    lib, stream = _load_cn(is_f32), _stream(m_in.device)
    B = m_in.shape[1]
    for blk in tables.cn_blocks:
        err = lib.lut_cn_std_frames(is_f32, m_in.data_ptr(), out.data_ptr(),
                                    synd.data_ptr(), rows.data_ptr(), blk.n_pad,
                                    blk.num_nodes, blk.edge_start, blk.degree, B,
                                    aligned, stream)
        _class_launched(err, "cn_std_pass",
                        lib.lut_cn_vec(is_f32, blk.degree, B, aligned) == 1)


def cn_std_pass(m_vn: torch.Tensor, tables: StdTables, generic: bool = False):
    """CN pass of a std graph on the VN-grouped slot-major v2c array: per
    degree class the min-LUT two-min and sign-parity update, per-frame
    syndrome of the input signs over the real checks; returns (VN-grouped
    c2v array, synd_ok (B,) bool), rows of padding variables unwritten.  CUDA
    tensors launch the CN frames, one launch per degree class, which read
    each check's inputs at their VN-grouped rows and write its outputs
    there: the row gathers by perm_v2c before the pass and by perm_c2v after
    it live inside the kernel's loads and stores (replaces
    lut_ldpc_tpu/decoder/qc_kernels.py::cn_std_pass and the two jnp.take of
    the JAX std loop around it).  generic=True gathers in torch around the
    table-driven kernel instead.  CPU tensors run cn_std_pass_ref."""
    _check_msgs(m_vn, tables.rows_vn, tables.cn_cls.device)
    if m_vn.device.type == "cpu":
        PLAIN_RUNS["cn_std_pass"] += 1
        return cn_std_pass_ref(m_vn, tables)
    _check_cn_degree(tables.max_dc, generic)
    B = m_vn.shape[1]
    _check_grid(tables.nchk_pad, B)
    synd = torch.ones(B, dtype=torch.bool, device=m_vn.device)
    if generic:
        m_cn = m_vn.index_select(0, tables.perm_v2c)
        out_cn = torch.empty_like(m_cn)
        err = _load().lut_cn_std_pass(
            int(m_cn.dtype == torch.float32), m_cn.data_ptr(), out_cn.data_ptr(),
            synd.data_ptr(), tables.cn_cls.data_ptr(), len(tables.cn_blocks),
            tables.nchk_pad, tables.max_dc, B, _stream(m_vn.device))
        _raise_on(err, "cn_std_pass")
        WITNESS_LAUNCHES["cn_std_pass"] += 1
        out = out_cn.index_select(0, tables.perm_c2v)
    else:
        out = torch.empty_like(m_vn)
        _cn_std_frames(m_vn, out, synd, tables, tables.inv_c2v)
    _launched("cn_std_pass", m_vn.dtype)
    return out, synd


def vn_std_pass_ref(m_c2v: torch.Tensor, cha: torch.Tensor, it: int,
                    params: VNParams, tables: StdTables):
    """Plain-torch twin of the std VN kernel: m_c2v (rows_vn, B) VN-grouped
    c2v values, cha (nvar_pad, B) -> (v2c values same layout, bits
    (nvar_pad, B) int8, unan (B,) bool).  Padding rows take no part in the
    unanimity and are left unwritten, as in the kernel."""
    B = m_c2v.shape[1]
    dev = m_c2v.device
    m_vn = torch.empty_like(m_c2v)
    bits = torch.empty((tables.nvar_pad, B), dtype=torch.int8, device=dev)
    unan = torch.ones(B, dtype=torch.bool, device=dev)
    prm = params.prm[it]
    for cls, blk in zip(params.classes, tables.vn_blocks):
        n0 = blk.node_start
        outs, neg0, agree = _vn_compute(
            cls, _planes(m_c2v, blk, B), cha[n0 : n0 + blk.num_nodes], prm)
        _planes(m_vn, blk, B).copy_(torch.stack(outs).to(m_c2v.dtype))
        bits[n0 : n0 + blk.num_nodes] = neg0.to(torch.int8)
        if agree is not None:
            unan &= agree.all(dim=0)
    return m_vn, bits, unan


def vn_std_pass(m_c2v: torch.Tensor, cha: torch.Tensor, it: int,
                params: VNParams, tables: StdTables, generic: bool = False):
    """VN pass for iteration `it` on the VN-grouped slot-major array (what
    cn_std_pass returns): per-class leave-one-out threshold trees, hard bits
    and per-frame sign unanimity over the real variables.  CUDA tensors
    launch the kernels generated for the spec, one launch per degree class
    (replaces lut_ldpc_tpu/decoder/qc_kernels.py::vn_std_pass), or with
    generic=True the table-driven kernel; CPU tensors run
    vn_std_pass_ref."""
    dev = m_c2v.device
    _check_msgs(m_c2v, tables.rows_vn, tables.vn_cls.device)
    B = m_c2v.shape[1]
    _check("cha", cha, m_c2v.dtype, (tables.nvar_pad, B), dev)
    if not 0 <= it < params.num_iters:
        raise IndexError(f"iteration {it} outside the spec's {params.num_iters}")
    blocks = tables.vn_blocks  # classes past the blocks': phantom true degrees
    if [c.degree for c in params.classes[: len(blocks)]] != [b.degree for b in blocks]:
        raise ValueError("params and tables describe different degree classes")
    if dev.type == "cpu":
        PLAIN_RUNS["vn_std_pass"] += 1
        return vn_std_pass_ref(m_c2v, cha, it, params, tables)
    _check_grid(tables.nvar_pad, B)
    m_vn = torch.empty_like(m_c2v)
    bits = torch.empty((tables.nvar_pad, B), dtype=torch.int8, device=dev)
    unan = torch.ones(B, dtype=torch.bool, device=dev)
    if generic:
        _check_vn_limits(params, tables.max_dv, dev)
        err = _load().lut_vn_std_pass(
            int(m_c2v.dtype == torch.float32), m_c2v.data_ptr(), cha.data_ptr(),
            m_vn.data_ptr(), bits.data_ptr(), unan.data_ptr(),
            tables.vn_cls.data_ptr(), len(tables.vn_blocks),
            params.cls_op0.data_ptr(), params.cls_nops.data_ptr(),
            params.op_info.data_ptr(), params.opnds.data_ptr(),
            params.prm.data_ptr(), int(it), params.prm.shape[1],
            tables.nvar_pad, tables.max_dv, B, _stream(dev))
        _raise_on(err, "vn_std_pass")
        WITNESS_LAUNCHES["vn_std_pass"] += 1
    else:
        lib = vn_codegen.library(params, m_c2v.dtype, "std").handle()
        aligned = _aligned(m_c2v, cha, m_vn, bits)
        row, stream = _prm_row(params, it), _stream(dev)
        for ci, blk in enumerate(blocks):
            err = lib.lut_vn_std_class(ci, m_c2v.data_ptr(), cha.data_ptr(), m_vn.data_ptr(),
                                       bits.data_ptr(), unan.data_ptr(), blk.node_start,
                                       blk.n_pad, blk.num_nodes, blk.edge_start, B,
                                       aligned, row, stream)
            _class_launched(err, "vn_std_pass", lib.lut_vn_vec(ci, B, aligned) == 1)
    _launched("vn_std_pass", m_c2v.dtype)
    return m_vn, bits, unan
