"""CN and VN passes of the quasi-cyclic value-domain decode.

``cn_qc_pass`` and ``vn_qc_pass`` take CUDA tensors to the hand-written
Hopper kernels of ``lut_ldpc_torch/csrc/qc_kernels.cu`` and CPU tensors to
their plain-torch twins ``cn_qc_pass_ref`` / ``vn_qc_pass_ref``, which sit
beside them and compute the same values.  A CUDA tensor never falls back
to a twin: the kernel launches or the wrapper raises.

They replace lut_ldpc_tpu/decoder/qc_kernels.py::cn_qc_pass (:549) and
::vn_qc_pass (:873), computing what those compute on the standard
slot-major grouped layout (no halo planes): messages (rows, B), frame axis
contiguous, every circulant shift a modular row index in the load.

The CUDA source is compiled with nvcc at first use into
``build/torch_kernels/`` (a shared library with a plain C interface,
loaded with ctypes) and launched on the current stream.  Each wrapper
counts its kernel launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from .params import QCTables, VNParams

__all__ = ["cn_qc_pass", "vn_qc_pass", "cn_qc_pass_ref", "vn_qc_pass_ref",
           "build_kernels", "LAUNCHES", "reset_launches", "KERNEL_SOURCE"]

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PKG_ROOT, "csrc", "qc_kernels.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_ROOT), "build", "torch_kernels")
_LIB_PATH = os.path.join(_BUILD_DIR, "libqc_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
MAX_DEGREE = 32  # widest row table the kernels are instantiated for
MAX_TREE_VALS = 64  # leaves + ops of one VN tree (kMaxVals in the source)

LAUNCHES = {"cn_qc_pass": 0, "vn_qc_pass": 0}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_kernels(force: bool = False) -> tuple:
    """Compile the kernel library if missing or older than its source;
    returns (library path, seconds spent compiling)."""
    if (not force and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(KERNEL_SOURCE)):
        return _LIB_PATH, 0.0
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, KERNEL_SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH, time.perf_counter() - t0


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build_kernels()
            lib = ctypes.CDLL(path)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.lut_cn_qc_pass.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, p]
            lib.lut_cn_qc_pass.restype = i
            lib.lut_vn_qc_pass.argtypes = ([i] + [p] * 16 + [i] * 6 + [p])
            lib.lut_vn_qc_pass.restype = i
            _lib = lib
        return _lib


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


def _check_grid(rows, Z, B):
    if rows * Z * -(-B // 256) >= 2**31:
        raise ValueError("grid too large for one launch")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# CN pass
# ---------------------------------------------------------------------------
def cn_qc_pass_ref(m_vn: torch.Tensor, tables: QCTables):
    """Plain-torch twin of the CN kernel: m_vn (rows_vn, B) -> (m_cn
    (rows_cn, B) same dtype, synd_ok (B,) bool).  Padding rows of m_cn are
    left unwritten (uninitialized), as in the kernel."""
    B = m_vn.shape[1]
    m_cn = torch.empty((tables.rows_cn, B), dtype=m_vn.dtype, device=m_vn.device)
    synd = torch.ones(B, dtype=torch.bool, device=m_vn.device)
    for src, dst in tables.cn_plain:
        x = m_vn[src.reshape(-1)].reshape(*src.shape, B).to(torch.float32)
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
        out = torch.where(par ^ neg, -tmp, tmp)
        m_cn[dst.reshape(-1)] = out.reshape(-1, B).to(m_vn.dtype)
        synd &= ~par.any(dim=0)
    return m_cn, synd


def cn_qc_pass(m_vn: torch.Tensor, tables: QCTables):
    """CN pass: v2c circulant rolls, min-LUT two-min and sign-parity update,
    per-frame syndrome of the input signs.  CUDA tensors launch the kernel
    (replaces lut_ldpc_tpu/decoder/qc_kernels.py::cn_qc_pass); CPU tensors
    run cn_qc_pass_ref."""
    dev = m_vn.device
    _check_msgs(m_vn, tables.rows_vn, tables.cn_src.device)
    if dev.type == "cpu":
        return cn_qc_pass_ref(m_vn, tables)
    B = m_vn.shape[1]
    if tables.max_dc > MAX_DEGREE:
        raise ValueError(f"check degree {tables.max_dc} > {MAX_DEGREE}")
    R = tables.cn_src.shape[0]
    _check_grid(R, tables.Z, B)
    m_cn = torch.empty((tables.rows_cn, B), dtype=m_vn.dtype, device=dev)
    synd = torch.ones(B, dtype=torch.bool, device=dev)
    err = _load().lut_cn_qc_pass(
        int(m_vn.dtype == torch.float32), m_vn.data_ptr(), m_cn.data_ptr(),
        synd.data_ptr(), tables.cn_src.data_ptr(), tables.cn_shift.data_ptr(),
        tables.cn_dst.data_ptr(), tables.cn_deg.data_ptr(), R, tables.Z,
        tables.max_dc, B, _stream(dev))
    _raise_on(err, "cn_qc_pass")
    LAUNCHES["cn_qc_pass"] += 1
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
        d = cls.degree
        msg = m_cn[src.reshape(-1)].reshape(d, -1, B).to(torch.float32)
        ch = cha[node].to(torch.float32)
        neg0 = agree = None
        for i in range(d):
            leaves = [msg[j] if j < i else msg[j + 1] for j in range(d - 1)]
            out = eval_vn_tree(cls, leaves + [ch], prm)
            m_vn[dst[i]] = out.to(m_cn.dtype)
            ni = out < 0
            if neg0 is None:
                neg0 = ni
            else:
                agree = (ni == neg0) if agree is None else agree & (ni == neg0)
        bits[node] = neg0.to(torch.int8)
        if agree is not None:
            unan &= agree.all(dim=0)
    return m_vn, bits, unan


def vn_qc_pass(m_cn: torch.Tensor, cha: torch.Tensor, it: int,
               params: VNParams, tables: QCTables):
    """VN pass for iteration `it`: c2v circulant rolls, per-class
    leave-one-out threshold trees, hard bits and per-frame sign unanimity.
    CUDA tensors launch the kernel (replaces
    lut_ldpc_tpu/decoder/qc_kernels.py::vn_qc_pass); CPU tensors run
    vn_qc_pass_ref.  The iteration's parameters are read on the device from
    params.prm[it]."""
    dev = m_cn.device
    _check_msgs(m_cn, tables.rows_cn, tables.vn_src.device)
    B = m_cn.shape[1]
    _check("cha", cha, m_cn.dtype, (tables.nvar_pad, B), dev)
    if not 0 <= it < params.num_iters:
        raise IndexError(f"iteration {it} outside the spec's {params.num_iters}")
    if dev.type == "cpu":
        return vn_qc_pass_ref(m_cn, cha, it, params, tables)
    if tables.max_dv > MAX_DEGREE:
        raise ValueError(f"variable degree {tables.max_dv} > {MAX_DEGREE}")
    if params.max_vals > MAX_TREE_VALS:
        raise ValueError(f"VN tree of {params.max_vals} values > {MAX_TREE_VALS}")
    if params.prm.device != dev:
        raise ValueError(f"params on {params.prm.device}, expected {dev}")
    R = tables.vn_src.shape[0]
    _check_grid(R, tables.Z, B)
    m_vn = torch.empty((tables.rows_vn, B), dtype=m_cn.dtype, device=dev)
    bits = torch.empty((tables.nvar_pad, B), dtype=torch.int8, device=dev)
    unan = torch.ones(B, dtype=torch.bool, device=dev)
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
    LAUNCHES["vn_qc_pass"] += 1
    return m_vn, bits, unan
