"""CN and VN passes of one degree block.

Counterpart of lut_ldpc_tpu/decoder/pallas_kernels.py: ``cn_block_pass``
replaces ``cn_pass`` (:115) and ``vn_block_pass`` replaces ``vn_pass``
(:227).  Both work on one degree block of the standard slot-major layout,
``m3`` (d, n_pad, B) with the frame axis contiguous and rows at or past
``n_real`` padding:

- the CN pass is the min-LUT two-min and sign-parity update plus the
  per-frame syndrome flag of the block, from the INPUT sign parities;
- the VN pass evaluates the block's threshold tree in full for each of the d
  leave-one-out outputs, leaves taken through the caller's ``loo`` table
  (no shared sweeps, unlike ``vn_std_pass``), every op a plain select chain
  over its ``thr`` / ``levels`` with ``tie_lo`` / ``tie_hi`` at a zero sum,
  op 0 as total-minus-self under ``use_tot``; plus hard bits (sign of
  output 0) and the per-frame unanimity of the output signs.

CUDA tensors go to ``cn_block_kernel`` of ``lut_ldpc_torch/csrc/qc_kernels.cu``
and to ``vn_block_class_kernel``, the block entry of ``csrc/vn_frames.cuh``
around the block's tree generated as straight-line code (``vn_program`` ->
``vn_codegen``, kind "block"); the table-driven ``vn_block_kernel`` of
``qc_kernels.cu`` runs only for ``generic=True`` (the witness).  CPU tensors
go to the plain versions ``cn_block_pass_ref`` / ``vn_block_pass_ref``
beside them.  A CUDA tensor never falls back: the kernel launches or the
wrapper raises.  What the TPU kernels needed for Mosaic (tile sizes, (8, BT)
flag rows, a batch that is a multiple of 128) is gone: any B and any n_pad
are accepted.  Padding rows of the outputs are left unwritten.

A decoder that runs the VN pass every iteration packs the tree and all its
iterations' parameters once (``vn_block_program``) and calls
``vn_blocks_pass``, which runs every VN layout block of the per-degree-block
loop in one unit: it reads the CN-grouped c2v array through the layout's
``perm_c2v`` (the loop's row gather folded into the kernels' loads) and
writes the VN-grouped outputs and the bits of every block into one array
each (no concatenation).  ``cn_block_pass`` takes an ``out=`` view, so the
loop's CN blocks write one CN-grouped array.  ``run_vn_block`` runs one
packed block on its own (d, n_pad, B) planes; ``vn_block_pass`` packs one
iteration's parameters and runs that, the way examples/profile_pallas.py
calls ``vn_pass``.

``qc_kernels.LAUNCHES`` counts the wrappers' calls that launched (one a pass
of ``vn_blocks_pass``), ``qc_kernels.CLASS_LAUNCHES`` the kernel launches
(the CN block kernel, the generated VN block kernels; the witness adds
none).
"""

from __future__ import annotations

from dataclasses import dataclass

import hashlib

import numpy as np
import torch

from . import qc_kernels as qk
from . import vn_codegen
from .params import FLAG_SORTED, FLAG_TIE, StdTables, VNOp
from .vn_program import VNProgram, build_block_program

__all__ = ["cn_block_pass", "cn_block_pass_ref", "vn_block_pass",
           "vn_block_pass_ref", "vn_block_program", "run_vn_block",
           "run_vn_block_ref", "vn_blocks_pass", "vn_blocks_pass_ref",
           "VNBlockProgram"]

KSLOTS = ("thr", "levels", "tie_lo", "tie_hi")
MAX_PARAM_BYTES = 48 * 1024  # one iteration's parameters, staged in shared memory


def _check_block(m3, n_real):
    if m3.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"messages: dtype {m3.dtype}, expected int16 or float32")
    if m3.dim() != 3:
        raise ValueError(f"messages: shape {tuple(m3.shape)}, expected (d, n_pad, B)")
    if not m3.is_contiguous():
        raise ValueError("messages: not contiguous")
    d, n_pad, B = m3.shape
    if not 0 <= n_real <= n_pad:
        raise ValueError(f"n_real {n_real} outside [0, {n_pad}]")
    if d < 1 or d > qk.MAX_DEGREE:
        raise ValueError(f"degree {d} outside [1, {qk.MAX_DEGREE}]")
    return d, n_pad, B


# ---------------------------------------------------------------------------
# CN pass
# ---------------------------------------------------------------------------
def _out(m3, out):
    """`out` checked against m3's dtype, shape and device, or a new array."""
    if out is None:
        return torch.empty_like(m3)
    qk._check("out", out, m3.dtype, m3.shape, m3.device)
    return out


def cn_block_pass_ref(m3: torch.Tensor, n_real: int, out=None):
    """Plain version of ``cn_block_pass``."""
    d, n_pad, B = _check_block(m3, n_real)
    out = _out(m3, out)
    o, par = qk._cn_compute(m3[:, :n_real])
    out[:, :n_real] = o.to(m3.dtype)
    return out, ~par.any(dim=0)


def cn_block_pass(m3: torch.Tensor, n_real: int, out=None):
    """Min-LUT CN update of one degree block: m3 (d, n_pad, B) int16 or
    float32 -> (out (d, n_pad, B) same dtype, synd_ok (B,) bool): running
    min1 / min2 over the d slots, a slot attaining min1 gets min2 and every
    other min1, signed by the parity of the input signs XOR the slot's own;
    synd_ok is true where every real check's input parity is even.  `out`:
    a contiguous (d, n_pad, B) array (a view) the outputs go to, or None for
    a new one."""
    d, n_pad, B = _check_block(m3, n_real)
    if m3.device.type == "cpu":
        qk.count(qk.PLAIN_RUNS, "cn_block_pass")
        return cn_block_pass_ref(m3, n_real, out)
    qk._check_grid(n_pad, B)
    out = _out(m3, out)
    synd = torch.ones(B, dtype=torch.bool, device=m3.device)
    if n_real and B:
        lib = qk._load()
        with qk.launch_on(m3.device) as stream:
            err = lib.lut_cn_block_pass(
                int(m3.dtype == torch.float32), m3.data_ptr(), out.data_ptr(),
                synd.data_ptr(), d, n_pad, n_real, B, stream)
        qk._class_launched(err, "cn_block_pass")
        qk._launched("cn_block_pass", m3.dtype)
    return out, synd


# ---------------------------------------------------------------------------
# VN pass
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class VNBlockProgram:
    """One block's tree and its per-iteration parameters: the straight-line
    program the generated kernel runs, and the same tree in the table-driven
    kernel's tables (the op_info / operand layout of ``params.VNParams``;
    flags: tie always, sorted where an op's thresholds ascend in every
    iteration)."""
    degree: int
    ops: tuple          # params.VNOp per op (sym False, has_tie True)
    loo: np.ndarray     # (d, d) leave-one-out index table
    use_tot: bool
    prm: torch.Tensor   # (iterations, row) float32
    op_info: torch.Tensor
    opnds: torch.Tensor
    loo_dev: torch.Tensor
    program: VNProgram  # vn_program.build_block_program of (ops, loo, use_tot)
    key: str            # sha256 of the program: its generated unit's key
    prm_host: np.ndarray  # prm in host memory (kernel arguments)

    @property
    def num_iters(self) -> int:
        return self.prm.shape[0]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32).reshape(-1)


def vn_block_program(struct, prm_iters, loo, use_tot, device) -> VNBlockProgram:
    """Pack a block's tree (`struct`: its ArithTreeSpec), the per-op
    parameter dicts of each iteration (`prm_iters`: a list over iterations
    of lists over ops of {thr, levels, tie_lo, tie_hi}) and the (d, d)
    leave-one-out table for ``run_vn_block``.  Raises ValueError on a tree
    the kernel cannot express."""
    d = int(struct.num_inputs)
    loo = np.asarray(loo, dtype=np.int64)
    if loo.shape != (d, d):
        raise ValueError(f"loo: shape {loo.shape}, expected ({d}, {d})")
    if d > 1 and (loo[:, : d - 1].min() < 0 or loo[:, : d - 1].max() >= d):
        raise ValueError("loo: message index outside the block's d slots")
    if d > qk.MAX_DEGREE:
        raise ValueError(f"degree {d} > {qk.MAX_DEGREE}")
    nops = len(struct.ops)
    if nops > qk.MAX_TREE_OPS:
        raise ValueError(f"VN tree of {nops} ops > {qk.MAX_TREE_OPS}")
    if not prm_iters or any(len(p) != nops for p in prm_iters):
        raise ValueError("parameters: one dict per op and iteration expected")
    if use_tot and (nops == 0 or d < 2):
        raise ValueError("use_tot needs an op 0 over the messages")
    ops, cols, off = [], [], 0
    for oi, op in enumerate(struct.ops):
        operands = tuple(int(x) for x in op.operands)
        if not operands or any(not 0 <= x < d + oi for x in operands):
            raise ValueError(f"op {oi}: operands {operands} outside its "
                             f"{d} leaves and {oi} earlier ops")
        rows = [[_f32(p[oi][k]) for k in KSLOTS] for p in prm_iters]
        nthr = len(rows[0][0])
        for thr, lev, tlo, thi in rows:
            if len(thr) != nthr or len(lev) != nthr + 1 or len(tlo) != 1 or len(thi) != 1:
                raise ValueError(f"op {oi}: thr ({nthr},), levels ({nthr + 1},) "
                                 "and scalar ties expected in every iteration")
        thr = np.stack([r[0] for r in rows])
        ops.append(VNOp(operands=operands, nthr=nthr, sym=False, has_tie=True,
                        sorted_thr=bool(np.all(np.diff(thr, axis=1) >= 0)),
                        fp=False, off=off, span=(-1, -1)))
        cols.append(np.concatenate([np.concatenate(r) for r in rows]).reshape(
            len(rows), 2 * nthr + 3))
        off += 2 * nthr + 3
    if off * 4 > MAX_PARAM_BYTES:
        raise ValueError(f"{off} parameters an iteration exceed shared memory")
    prm = (np.concatenate(cols, axis=1) if cols
           else np.zeros((len(prm_iters), 0), np.float32))
    op_info, opnds = [], []
    for op in ops:
        flags = FLAG_TIE | (FLAG_SORTED if op.sorted_thr else 0)
        op_info += [len(opnds), len(op.operands), op.nthr, flags, op.off, *op.span]
        opnds += list(op.operands)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32).reshape(-1), device=device)
    program = build_block_program(d, ops, loo, use_tot)
    prm = np.ascontiguousarray(prm, dtype=np.float32)
    return VNBlockProgram(
        degree=d, ops=tuple(ops), loo=loo, use_tot=bool(use_tot),
        prm=torch.as_tensor(prm, device=device).contiguous(),
        op_info=i32(op_info), opnds=i32(opnds), loo_dev=i32(loo),
        program=program, key=hashlib.sha256(repr(program).encode()).hexdigest(),
        prm_host=prm)


def _check_vn(m3, cha, prog, it, n_real):
    d, n_pad, B = _check_block(m3, n_real)
    if d != prog.degree:
        raise ValueError(f"block of degree {d}, program of degree {prog.degree}")
    qk._check("cha", cha, m3.dtype, (n_pad, B), m3.device)
    if prog.prm.device != m3.device:
        raise ValueError(f"program on {prog.prm.device}, messages on {m3.device}")
    if not 0 <= it < prog.num_iters:
        raise IndexError(f"iteration {it} outside the program's {prog.num_iters}")
    return d, n_pad, B


def run_vn_block_ref(m3, cha, prog, it, n_real):
    """Plain version of ``run_vn_block``."""
    d, n_pad, B = _check_vn(m3, cha, prog, it, n_real)
    dev = m3.device
    out = torch.empty_like(m3)
    bits = torch.empty((n_pad, B), dtype=torch.uint8, device=dev)
    m = m3[:, :n_real].to(torch.float32)
    ch = cha[:n_real].to(torch.float32)
    prm = prog.prm[it]
    tot = None
    if prog.use_tot:
        tot = m[0]
        for j in range(1, d):
            tot = tot + m[j]
    neg0 = agree = None
    for i in range(d):
        vals = [m[int(prog.loo[i, x])] for x in range(d - 1)] + [ch]
        for oi, op in enumerate(prog.ops):
            if oi == 0 and tot is not None:
                s = tot - m[i]
            else:
                s = vals[op.operands[0]]
                for sl in op.operands[1:]:
                    s = s + vals[sl]
            tie = torch.where(vals[op.operands[-1]] < 0,
                              prm[op.off + 2 * op.nthr + 1],
                              prm[op.off + 2 * op.nthr + 2])
            vals.append(torch.where(s == 0, tie, qk._emit(s, prm, op)))
        out[i, :n_real] = vals[-1].to(m3.dtype)
        ni = vals[-1] < 0
        if neg0 is None:
            neg0 = ni
        else:
            agree = (ni == neg0) if agree is None else agree & (ni == neg0)
    bits[:n_real] = neg0.to(torch.uint8)
    unan = (agree.all(dim=0) if agree is not None
            else torch.ones(B, dtype=torch.bool, device=dev))
    return out, bits, unan


def _prm_row(prog: VNBlockProgram, it: int) -> int:
    """Host address of iteration `it`'s parameter row."""
    return prog.prm_host.ctypes.data + int(it) * prog.prm_host.strides[0]


def run_vn_block(m3: torch.Tensor, cha: torch.Tensor, prog: VNBlockProgram,
                 it: int, n_real: int, generic: bool = False):
    """``vn_block_pass`` with the tree and the parameters of iteration `it`
    taken from a packed program.  CUDA tensors launch the kernel generated
    for the program (the unit of a decoder that holds it, or one of its
    own), or with generic=True the table-driven kernel."""
    d, n_pad, B = _check_vn(m3, cha, prog, it, n_real)
    dev = m3.device
    if dev.type == "cpu":
        qk.count(qk.PLAIN_RUNS, "vn_block_pass")
        return run_vn_block_ref(m3, cha, prog, it, n_real)
    qk._check_grid(n_pad, B)
    out = torch.empty_like(m3)
    bits = torch.empty((n_pad, B), dtype=torch.uint8, device=dev)
    unan = torch.ones(B, dtype=torch.bool, device=dev)
    if not (n_real and B):
        return out, bits, unan
    if generic:
        lib = qk._load()
        with qk.launch_on(dev) as stream:
            err = lib.lut_vn_block_pass(
                int(m3.dtype == torch.float32), m3.data_ptr(), cha.data_ptr(),
                out.data_ptr(), bits.data_ptr(), unan.data_ptr(),
                prog.op_info.data_ptr(), prog.opnds.data_ptr(),
                prog.loo_dev.data_ptr(), prog.prm.data_ptr(), int(it),
                prog.prm.shape[1], d, len(prog.ops), int(prog.use_tot), n_pad,
                n_real, B, stream)
        qk._raise_on(err, "vn_block_pass")
        qk.count(qk.WITNESS_LAUNCHES, "vn_block_pass")
    else:
        unit, c = vn_codegen.block_class(prog, m3.dtype)
        lib = unit.handle()
        with qk.launch_on(dev) as stream:
            err = lib.lut_vn_block_class(
                c, m3.data_ptr(), None, cha.data_ptr(), out.data_ptr(),
                bits.data_ptr(), unan.data_ptr(), 0, n_pad, n_real, 0, B,
                qk._aligned(m3, cha, out, bits), _prm_row(prog, it), stream)
        qk._class_launched(err, "vn_block_pass")
    qk._launched("vn_block_pass", m3.dtype)
    return out, bits, unan


def vn_block_pass_ref(m3, cha, struct, prm, loo, use_tot, n_real: int):
    """Plain version of ``vn_block_pass``."""
    prog = vn_block_program(struct, [prm], loo, use_tot, m3.device)
    return run_vn_block_ref(m3, cha, prog, 0, n_real)


def vn_block_pass(m3, cha, struct, prm, loo, use_tot, n_real: int):
    """Leave-one-out VN tree update of one degree block: m3 (d, n_pad, B)
    c2v values and cha (n_pad, B) channel values, int16 or float32; struct
    the block's ArithTreeSpec; prm one iteration's per-op {thr, levels,
    tie_lo, tie_hi}; loo the (d, d) leave-one-out table (column d - 1 is the
    channel).  Returns (out (d, n_pad, B), bits (n_pad, B) uint8, unan (B,)
    bool)."""
    prog = vn_block_program(struct, [prm], loo, use_tot, m3.device)
    return run_vn_block(m3, cha, prog, 0, n_real)


# ---------------------------------------------------------------------------
# the VN pass of the per-degree-block loop: every VN layout block
# ---------------------------------------------------------------------------
def _check_blocks(m_cn, cha, it, progs, tables):
    qk._check_msgs(m_cn, tables.rows_cn, tables.perm_c2v.device)
    B = m_cn.shape[1]
    qk._check("cha", cha, m_cn.dtype, (tables.nvar_pad, B), m_cn.device)
    if [p.degree for p in progs] != [b.degree for b in tables.vn_blocks]:
        raise ValueError("programs and tables describe different degree blocks")
    for p in progs:
        if p.prm.device != m_cn.device:
            raise ValueError(f"program on {p.prm.device}, messages on {m_cn.device}")
        if not 0 <= it < p.num_iters:
            raise IndexError(f"iteration {it} outside the program's {p.num_iters}")
    return B


def vn_blocks_pass_ref(m_cn: torch.Tensor, cha: torch.Tensor, it: int, progs,
                       tables: StdTables):
    """Plain version of ``vn_blocks_pass``: the gather by perm_c2v, then
    ``run_vn_block_ref`` on each block's planes."""
    B = _check_blocks(m_cn, cha, it, progs, tables)
    m_new = m_cn.index_select(0, tables.perm_c2v)
    m_vn = torch.empty_like(m_new)
    bits = torch.empty((tables.nvar_pad, B), dtype=torch.int8, device=m_cn.device)
    unan = torch.ones(B, dtype=torch.bool, device=m_cn.device)
    for blk, prog in zip(tables.vn_blocks, progs):
        d, n, e0, n0 = blk.degree, blk.n_pad, blk.edge_start, blk.node_start
        out, b, u = run_vn_block_ref(m_new[e0 : e0 + n * d].view(d, n, B),
                                     cha[n0 : n0 + n], prog, it, blk.num_nodes)
        qk._planes(m_vn, blk, B).copy_(out[:, : blk.num_nodes])
        bits[n0 : n0 + blk.num_nodes] = b[: blk.num_nodes].view(torch.int8)
        unan &= u
    return m_vn, bits, unan


def vn_blocks_pass(m_cn: torch.Tensor, cha: torch.Tensor, it: int, progs,
                   tables: StdTables):
    """The VN pass of the per-degree-block loop at iteration `it`: m_cn
    (rows_cn, B) the CN-grouped c2v values, cha (nvar_pad, B) the grouped
    channel values, progs one packed program per VN layout block of
    `tables` -> (VN-grouped v2c values (rows_vn, B), bits (nvar_pad, B)
    int8, unan (B,) bool); rows of padding variables unwritten.  CUDA
    tensors launch the unit generated for `progs`, one launch per block,
    each reading its c2v inputs at rows perm_c2v[slot row] of m_cn (the
    gather of the JAX loop folded into the loads) and writing its outputs
    and bits in place in the two arrays.  CPU tensors run
    vn_blocks_pass_ref."""
    B = _check_blocks(m_cn, cha, it, progs, tables)
    dev = m_cn.device
    if dev.type == "cpu":
        qk.count(qk.PLAIN_RUNS, "vn_block_pass")
        return vn_blocks_pass_ref(m_cn, cha, it, progs, tables)
    qk._check_grid(tables.nvar_pad, B)
    m_vn = torch.empty((tables.rows_vn, B), dtype=m_cn.dtype, device=dev)
    bits = torch.empty((tables.nvar_pad, B), dtype=torch.int8, device=dev)
    unan = torch.ones(B, dtype=torch.bool, device=dev)
    lib = vn_codegen.block_library(progs, m_cn.dtype).handle()
    aligned = qk._aligned(m_cn, cha, m_vn, bits)
    with qk.launch_on(dev) as stream:
        for c, (blk, prog) in enumerate(zip(tables.vn_blocks, progs)):
            err = lib.lut_vn_block_class(
                c, m_cn.data_ptr(), tables.perm_c2v.data_ptr(), cha.data_ptr(),
                m_vn.data_ptr(), bits.data_ptr(), unan.data_ptr(), blk.node_start,
                blk.n_pad, blk.num_nodes, blk.edge_start, B, aligned,
                _prm_row(prog, it), stream)
            qk._class_launched(err, "vn_block_pass")
    qk._launched("vn_block_pass", m_cn.dtype)
    return m_vn, bits, unan
