"""The VN update of one degree class or block as a straight-line program.

``build_block_program`` turns a VN tree (its ops, ``params.VNOp`` records),
a (d, d) leave-one-out table and the ``use_tot`` flag into the list of op
evaluations that the d outputs need, decided once on the host.  Output i is
the tree on the leaves of row i of the table: message leaf position x takes
message ``loo[i, x]``, the channel is the last leaf; under ``use_tot`` op 0
sums (m_0 + ... + m_{d-1}) - m_i instead of its operands (what
lut_ldpc_tpu/decoder/pallas_kernels.py::_vn_kernel computes).  The outputs
are built in the order d - 1, 0, 1, ..., d - 2, and two steps with the same
op and the same operands are one step.

``build_vn_program`` is the program of a ``VNClass`` (``params.py``): the
standard table ``leave_one_out_idx(d + 1, d)``, where position j of output i
takes m_j for j < i and m_{j+1} otherwise.  There the merging is the
shared-sweep schedule of
lut_ldpc_tpu/decoder/qc_kernels.py::_vn_class_compute, value for value:

- output d - 1 is the identity sweep, the tree bottom-up on
  (m_0 .. m_{d-2}, channel);
- output 0 is the shift-by-one sweep, on (m_1 .. m_{d-1}, channel);
- an inner output i re-evaluates only the ops whose message span straddles
  i (lo < i <= hi): a sub-tree wholly below i reads the leaves of the
  identity sweep, one wholly at or above i those of the shifted sweep, so
  their steps merge with those sweeps' (degree 17: 96 steps, not 272).

Any other table is computed exactly, with the merges its rows allow.  Every
step sums its operands left to right in float32 in the tree's operand order
and emits through the op's select chain.  Degree 1 has no message leaf: its
one output is the channel value (or the root of a channel-only tree).

A program is plain data: steps name their operands as message leaves, the
channel or earlier steps.  ``vn_codegen`` writes a program out as CUDA / C++
source; ``eval_vn_program`` runs it on tensors (any device) and is the plain
reference of that source.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .layout import leave_one_out_idx

__all__ = ["Step", "VNProgram", "build_vn_program", "build_block_program",
           "eval_vn_program"]

# an operand: ("m", k) message k of the node, ("c",) its channel value,
# ("s", j) the value of step j
MSG, CHA, STEP = "m", "c", "s"


@dataclass(frozen=True)
class Step:
    name: str        # "i3" / "s3": op 3 for output d - 1 / 0 (the identity /
                     # shifted sweep); "t5_3": op 3 evaluated for output 5
    op: int          # index into VNProgram.ops: the emission parameters
    operands: tuple  # operand references, in the tree's operand order
    # ("m", i): the sum is (m_0 + ... + m_{d-1}) - m_i (op 0 under use_tot);
    # the operands then only name the tie's last operand
    minus: tuple | None = None


@dataclass(frozen=True)
class VNProgram:
    degree: int
    ops: tuple       # the tree's VNOp records
    steps: tuple
    outputs: tuple   # operand reference of each of the d outputs


def build_block_program(degree: int, ops, loo, use_tot: bool = False) -> VNProgram:
    """The straight-line program of the tree `ops` with `degree` leaves (d - 1
    messages, then the channel) for the d leave-one-out outputs of the
    (d, d) table `loo` (column d - 1, the channel's, is not read)."""
    d, ops = int(degree), tuple(ops)
    loo = np.asarray(loo)
    steps, index = [], {}

    def step(name, k, operands, minus):
        key = (k, operands, minus)
        if key not in index:
            index[key] = len(steps)
            steps.append(Step(name, k, operands, minus))
        return (STEP, index[key])

    outputs = [None] * d
    for i in [d - 1] + list(range(d - 1)):
        tag = "i" if i == d - 1 else ("s" if i == 0 else f"t{i}_")
        vals = [(MSG, int(loo[i, x])) for x in range(d - 1)] + [(CHA,)]
        for k, op in enumerate(ops):
            minus = (MSG, i) if use_tot and k == 0 else None
            vals.append(step(f"{tag}{k}", k, tuple(vals[x] for x in op.operands),
                             minus))
        outputs[i] = vals[-1]
    return VNProgram(degree=d, ops=ops, steps=tuple(steps), outputs=tuple(outputs))


def build_vn_program(cls) -> VNProgram:
    """The straight-line leave-one-out program of the VNClass `cls`."""
    d = cls.degree
    if cls.num_inputs != d:
        raise ValueError("VN tree leaves != degree (d-1 messages + channel)")
    return build_block_program(d, cls.ops, leave_one_out_idx(d + 1, d))


def _emit(s, last, prm, op):
    """The emission of `op` for the operand sum s (float32 tensor): the
    select chain out = lev[0]; out = lev[t + 1] where x >= thr[t]; a sym op
    chains on |s| and restores the sign; a tie op emits tie_lo / tie_hi at
    s == 0 by the sign of `last`, the op's last operand."""
    thr = prm[op.off : op.off + op.nthr]
    lev = prm[op.off + op.nthr : op.off + 2 * op.nthr + 1]
    x = s.abs() if op.sym else s
    out = lev[0].expand_as(s)
    for t in range(op.nthr):
        out = torch.where(x >= thr[t], lev[t + 1], out)
    if op.sym:
        out = torch.where(s < 0, -out, out)
    if op.has_tie:
        tie = torch.where(last < 0, prm[op.off + 2 * op.nthr + 1],
                          prm[op.off + 2 * op.nthr + 2])
        out = torch.where(s == 0, tie, out)
    return out


def eval_vn_program(program: VNProgram, msg, ch, prm):
    """Run `program` on msg (d, ...) messages and ch (...) channel values
    with prm, one iteration's parameter row: (list of the d float32 outputs,
    sign of output 0, agreement of all output signs or None for d == 1), as
    ``qc_kernels._vn_compute`` returns them."""
    msg = msg.to(torch.float32)
    ch = ch.to(torch.float32)
    vals, tot = [], None

    def get(ref):
        if ref[0] == MSG:
            return msg[ref[1]]
        return ch if ref[0] == CHA else vals[ref[1]]

    for st in program.steps:
        xs = [get(r) for r in st.operands]
        if st.minus is not None:
            if tot is None:
                tot = msg[0]
                for j in range(1, program.degree):
                    tot = tot + msg[j]
            s = tot - get(st.minus)
        else:
            s = xs[0]
            for x in xs[1:]:
                s = s + x
        vals.append(_emit(s, xs[-1], prm, program.ops[st.op]))
    outs = [get(r) for r in program.outputs]
    neg0 = outs[0] < 0
    agree = None
    for o in outs[1:]:
        a = (o < 0) == neg0
        agree = a if agree is None else agree & a
    return outs, neg0, agree
