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

CUDA tensors go to ``cn_block_kernel`` / ``vn_block_kernel`` of
``lut_ldpc_torch/csrc/qc_kernels.cu`` (built and loaded by ``qc_kernels``,
counted in its ``LAUNCHES``); CPU tensors go to the plain versions
``cn_block_pass_ref`` / ``vn_block_pass_ref`` beside them.  A CUDA tensor
never falls back: the kernel launches or the wrapper raises.  What the TPU
kernels needed for Mosaic (tile sizes, (8, BT) flag rows, a batch that is a
multiple of 128) is gone: any B and any n_pad are accepted.  Padding rows of
the outputs are left unwritten.

A decoder that runs the VN pass every iteration packs the tree and all its
iterations' parameters once (``vn_block_program``) and calls
``run_vn_block``; ``vn_block_pass`` does both for one iteration's
parameters, the way examples/profile_pallas.py calls ``vn_pass``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import qc_kernels as qk
from .params import FLAG_SORTED, FLAG_TIE, VNOp

__all__ = ["cn_block_pass", "cn_block_pass_ref", "vn_block_pass",
           "vn_block_pass_ref", "vn_block_program", "run_vn_block",
           "run_vn_block_ref",
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
def cn_block_pass_ref(m3: torch.Tensor, n_real: int):
    """Plain version of ``cn_block_pass``."""
    d, n_pad, B = _check_block(m3, n_real)
    out = torch.empty_like(m3)
    o, par = qk._cn_compute(m3[:, :n_real])
    out[:, :n_real] = o.to(m3.dtype)
    return out, ~par.any(dim=0)


def cn_block_pass(m3: torch.Tensor, n_real: int):
    """Min-LUT CN update of one degree block: m3 (d, n_pad, B) int16 or
    float32 -> (out (d, n_pad, B) same dtype, synd_ok (B,) bool): running
    min1 / min2 over the d slots, a slot attaining min1 gets min2 and every
    other min1, signed by the parity of the input signs XOR the slot's own;
    synd_ok is true where every real check's input parity is even."""
    d, n_pad, B = _check_block(m3, n_real)
    if m3.device.type == "cpu":
        return cn_block_pass_ref(m3, n_real)
    qk._check_grid(n_pad, B)
    out = torch.empty_like(m3)
    synd = torch.ones(B, dtype=torch.bool, device=m3.device)
    if n_real and B:
        err = qk._load().lut_cn_block_pass(
            int(m3.dtype == torch.float32), m3.data_ptr(), out.data_ptr(),
            synd.data_ptr(), d, n_pad, n_real, B, qk._stream(m3.device))
        qk._raise_on(err, "cn_block_pass")
        qk._launched("cn_block_pass", m3.dtype)
    return out, synd


# ---------------------------------------------------------------------------
# VN pass
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class VNBlockProgram:
    """One block's tree and its per-iteration parameters in the kernel's
    tables (the op_info / operand layout of ``params.VNParams``; flags: tie
    always, sorted where an op's thresholds ascend in every iteration)."""
    degree: int
    ops: tuple          # params.VNOp per op (sym False, has_tie True)
    loo: np.ndarray     # (d, d) leave-one-out index table
    use_tot: bool
    prm: torch.Tensor   # (iterations, row) float32
    op_info: torch.Tensor
    opnds: torch.Tensor
    loo_dev: torch.Tensor

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
    return VNBlockProgram(
        degree=d, ops=tuple(ops), loo=loo, use_tot=bool(use_tot),
        prm=torch.as_tensor(prm, device=device).contiguous(),
        op_info=i32(op_info), opnds=i32(opnds), loo_dev=i32(loo))


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


def run_vn_block(m3: torch.Tensor, cha: torch.Tensor, prog: VNBlockProgram,
                 it: int, n_real: int):
    """``vn_block_pass`` with the tree and the parameters of iteration `it`
    taken from a packed program."""
    d, n_pad, B = _check_vn(m3, cha, prog, it, n_real)
    dev = m3.device
    if dev.type == "cpu":
        return run_vn_block_ref(m3, cha, prog, it, n_real)
    qk._check_grid(n_pad, B)
    out = torch.empty_like(m3)
    bits = torch.empty((n_pad, B), dtype=torch.uint8, device=dev)
    unan = torch.ones(B, dtype=torch.bool, device=dev)
    if n_real and B:
        err = qk._load().lut_vn_block_pass(
            int(m3.dtype == torch.float32), m3.data_ptr(), cha.data_ptr(),
            out.data_ptr(), bits.data_ptr(), unan.data_ptr(),
            prog.op_info.data_ptr(), prog.opnds.data_ptr(),
            prog.loo_dev.data_ptr(), prog.prm.data_ptr(), int(it),
            prog.prm.shape[1], d, len(prog.ops), int(prog.use_tot), n_pad,
            n_real, B, qk._stream(dev))
        qk._raise_on(err, "vn_block_pass")
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
