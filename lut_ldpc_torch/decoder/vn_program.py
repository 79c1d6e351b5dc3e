"""The VN update of one degree class as a straight-line program.

``build_vn_program`` turns a ``VNClass`` (``params.py``) into the list of op
evaluations that the leave-one-out update needs, decided once on the host:

- the identity sweep: the class tree bottom-up on the leaves
  (m_0 .. m_{d-2}, channel); its root is output d - 1;
- the shift-by-one sweep: the same tree on (m_1 .. m_{d-1}, channel); its
  root is output 0;
- for each inner output i only the ops whose message span straddles i
  (lo < i <= hi), evaluated on the leave-one-out leaves (position j takes
  m_j for j < i and m_{j+1} otherwise); a sub-tree wholly below i comes from
  the identity sweep, one wholly at or above i from the shifted sweep.

This is the shared-sweep schedule of
lut_ldpc_tpu/decoder/qc_kernels.py::_vn_class_compute, value for value: every
step sums its operands left to right in float32 in the tree's operand order
and emits through the op's select chain.  Degree 1 has no message leaf: its
one output is the channel value (or the root of a channel-only tree).

A program is plain data: steps name their operands as message leaves, the
channel or earlier steps.  Two steps with the same op and operands are one
step.  ``vn_codegen`` writes a program out as CUDA / C++ source;
``eval_vn_program`` runs it on tensors (any device) and is the plain
reference of that source.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Step", "VNProgram", "build_vn_program", "eval_vn_program"]

# an operand: ("m", k) message k of the node, ("c",) its channel value,
# ("s", j) the value of step j
MSG, CHA, STEP = "m", "c", "s"


@dataclass(frozen=True)
class Step:
    name: str        # "i3" / "s3": op 3 of the identity / shifted sweep;
                     # "t5_3": op 3 re-evaluated for output 5
    op: int          # index into VNProgram.ops: the emission parameters
    operands: tuple  # operand references, in the tree's operand order


@dataclass(frozen=True)
class VNProgram:
    degree: int
    ops: tuple       # the class's VNOp records
    steps: tuple
    outputs: tuple   # operand reference of each of the d outputs


def build_vn_program(cls) -> VNProgram:
    """The straight-line leave-one-out program of the VNClass `cls`."""
    d, ops = cls.degree, cls.ops
    if cls.num_inputs != d:
        raise ValueError("VN tree leaves != degree (d-1 messages + channel)")
    steps, index = [], {}

    def step(name, k, operands):
        key = (k, operands)
        if key not in index:
            index[key] = len(steps)
            steps.append(Step(name, k, operands))
        return (STEP, index[key])

    def sweep(tag, shift):
        vals = [(MSG, j + shift) for j in range(d - 1)] + [(CHA,)]
        for k, op in enumerate(ops):
            vals.append(step(f"{tag}{k}", k, tuple(vals[x] for x in op.operands)))
        return vals[d:]

    idv = sweep("i", 0)
    s1v = sweep("s", 1) if d >= 2 else idv
    outputs = []
    for i in range(d):
        if not ops:
            outputs.append((CHA,))
        elif i == d - 1:
            outputs.append(idv[-1])
        elif i == 0:
            outputs.append(s1v[-1])
        else:
            done = {}

            def val(x, i=i, done=done):
                if x < d - 1:
                    return (MSG, x if x < i else x + 1)
                if x == d - 1:
                    return (CHA,)
                k = x - d
                lo, hi = ops[k].span
                if lo < 0 or hi < i:
                    return idv[k]
                if lo >= i:
                    return s1v[k]
                if k not in done:
                    done[k] = step(f"t{i}_{k}", k,
                                   tuple(val(y) for y in ops[k].operands))
                return done[k]

            outputs.append(val(d + len(ops) - 1))
    return VNProgram(degree=d, ops=tuple(ops), steps=tuple(steps),
                     outputs=tuple(outputs))


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
    vals = []

    def get(ref):
        if ref[0] == MSG:
            return msg[ref[1]]
        return ch if ref[0] == CHA else vals[ref[1]]

    for st in program.steps:
        xs = [get(r) for r in st.operands]
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
