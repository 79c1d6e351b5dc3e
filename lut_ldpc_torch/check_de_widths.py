"""Does DELutGPU give a point the same result at every batch width?

A meshed explorer evolves shards of a grid, so each point's result must not
depend on how many points share its batch.  For each case this evolves a
batch and a prefix of it on one device, with the CUDA graph and eagerly,
and compares the prefix's outputs with the batch's first rows.  Where the
eager outputs differ, it traces every torch op of both runs
(TorchFunctionMode) and prints the first op whose output rows differ.
Exits 1 if any case differs.

    python -m lut_ldpc_torch.check_de_widths [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .core.ensemble import LDPCEnsemble
from .design import DELutGPU


class _Trace(TorchFunctionMode):
    """Every torch op's name, input shapes and (small) outputs on the host."""

    def __init__(self, limit: int = 20000):
        super().__init__()
        self.ops, self.limit = [], limit

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if len(self.ops) < self.limit:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            ins = [a for a in [*args, *(kwargs or {}).values()] if isinstance(a, torch.Tensor)]
            self.ops.append((getattr(func, "__name__", str(func)), [tuple(i.shape) for i in ins],
                             [o.detach().cpu().clone() if isinstance(o, torch.Tensor)
                              and o.numel() < 100000 else None for o in outs]))
        return out


def first_difference(wide, narrow, wa: int, wb: int) -> str:
    """The first op of two traces whose output's first wb rows differ."""
    for i, ((fa, sa, oa), (fb, sb, ob)) in enumerate(zip(wide, narrow)):
        if fa != fb:
            return f"the op sequences part at op {i}: {fa} / {fb}"
        for x, y in zip(oa, ob):
            if x is None or y is None or x.dim() == 0:
                continue
            xx = x[:wb] if (x.shape[0], y.shape[0]) == (wa, wb) else x
            if xx.shape == y.shape and not torch.equal(xx, y):
                diff = (xx.double() - y.double()).abs().max().item()
                return f"op {i} {fa}, inputs {sa} / {sb}: largest difference {diff:.3e}"
    return "no traced op differs"


def cases():
    ens36 = LDPCEnsemble(np.array([3]), np.array([1.0]), np.array([6]), np.array([1.0]))
    irr = LDPCEnsemble.read("ensembles/rate0.50_dv02-17_dc08-09_lut_q4.ens")
    reuse = np.zeros((6, 12), bool)
    for i in range(1, 5):
        reuse[i, 2 * i] = True
    reuse[5] = reuse[0]
    singles = np.resize(np.eye(30, dtype=bool)[1:], (100, 30))

    def grid(lo, hi, n):
        return lambda t, w: t.evolve_batch(np.linspace(lo, hi, n)[:w])
    kw36 = dict(ens=ens36, maxiter_de=60)
    kwirr = dict(ens=irr, maxiter_de=100, strategy="joint_root")
    return [
        ("(3,6) prerank_reuse", lambda t, w: t.prerank_reuse(0.85, reuse[:w]),
         dict(ens=ens36, maxiter_de=12), 5, 3),
        ("(3,6) prerank_reuse", lambda t, w: t.prerank_reuse(0.82, singles[:w]),
         dict(ens=ens36, maxiter_de=30), 99, 50),
        ("(3,6) evolve_batch", grid(0.8, 0.92, 11), kw36, 11, 6),
        ("(3,6) evolve_batch", grid(0.6, 1.0, 17), kw36, 17, 9),
        ("(3,6) evolve_batch", grid(0.6, 1.0, 64), kw36, 64, 5),
        ("irregular joint_root evolve_batch", grid(0.85, 0.97, 17), kwirr, 17, 9),
        ("irregular joint_root evolve_batch", grid(0.85, 0.97, 9), kwirr, 9, 1),
        ("(3,6) segmented evolve_batch", grid(0.8, 0.92, 11),
         dict(ens=ens36, maxiter_de=40, Nq_Msg=np.array([16] * 20 + [8] * 20)), 11, 6),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bad = 0
    for name, run, kw, wa, wb in cases():
        kw = dict(kw)
        ens = kw.pop("ens")
        for graph in (True, False):
            tde = DELutGPU(ens, Pe_max=1e-6, max_ni_de_iters=30, device=args.device, **kw)
            tde.graph = graph and tde.graph
            wide, narrow = run(tde, wa), run(tde, wb)
            same = all(np.array_equal(x[:wb], y) for x, y in zip(wide, narrow))
            print(f"{name}, width {wb} against {wa}, {'graph' if graph else 'eager'}: "
                  f"{'equal' if same else 'DIFFERENT'}", flush=True)
            if not same:
                bad += 1
                if not graph:
                    traces = [_Trace(), _Trace()]
                    for tr, w in zip(traces, (wa, wb)):
                        with tr:
                            run(tde, w)
                    print("   ", first_difference(traces[0].ops, traces[1].ops, wa, wb))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
