"""General label-domain table decoder (port of
lut_ldpc_tpu/decoder/lut_decoder.py).

``LUTDecoder`` is the last rung of the decoder ladder: it takes any codec,
per-iteration message resolutions that differ, CN LUT trees, and
phantom-completed graphs with the pinned-edge semantics of ``decode_ref``
(phantom v2c labels pinned to the strongest positive at each CN pass,
phantom nodes updated by their TRUE-degree trees over the real sockets with
the phantom sockets mirroring output 0, phantom pairs left out of the bit
syndrome).  Messages live in one (B, E) tensor in VN-major edge order; each
degree group's update is gather, compute, scatter.  The JAX class unrolls
its iterations at trace time; eager torch runs the same per-iteration
steps as a Python loop, in plain torch ops on labels (the JAX package has
no Pallas kernel for this decoder either).

``cn_minsum`` is the label-domain min-LUT check-node update it shares with
``FastLUTDecoder``, ``eval_program`` the tree-program evaluation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .arith_decoder import as_labels
from .layout import leave_one_out_idx, tree_program

__all__ = ["LUTDecoder", "cn_minsum", "eval_program"]


def cn_minsum(m: torch.Tensor, nz: int) -> torch.Tensor:
    """Min-sum CN update over the last axis on integer labels in
    [0, 2*nz): out_i = sign parity excluding i times min_{j != i} of the
    magnitudes, via prefix/suffix minima (LDPC_Code_LUT.cpp:355-402;
    degree-1 nodes get the nz initialization).  Same dtype as m."""
    d = m.shape[-1]
    neg = m < nz
    mag = torch.where(neg, nz - 1 - m, m - nz)
    fill = torch.full(m.shape[:-1], nz, dtype=mag.dtype, device=m.device)
    pre = [fill]
    for j in range(d - 1):
        pre.append(torch.minimum(pre[-1], mag[..., j]))
    suf = [fill]
    for j in range(d - 1, 0, -1):
        suf.append(torch.minimum(suf[-1], mag[..., j]))
    suf = suf[::-1]
    tmp = torch.stack([torch.minimum(pre[j], suf[j]) for j in range(d)], dim=-1)
    sign_prod = neg.sum(dim=-1, keepdim=True) & 1
    flip = (sign_prod == 1) ^ neg
    return torch.where(flip, nz - 1 - tmp, nz + tmp).to(m.dtype)


def eval_program(prog, tables, x: torch.Tensor) -> torch.Tensor:
    """Run a TreeProgram on x (..., num_inputs) integer labels with its
    per-op lookup tables; returns (...,) int64 labels."""
    vals = [x[..., i].to(torch.int64) for i in range(prog.num_inputs)]
    for op, table in zip(prog.ops, tables):
        label = vals[op.operands[0]] * op.bases[0]
        for b, s in zip(op.bases[1:], op.operands[1:]):
            label = label + b * vals[s]
        vals.append(table[label].to(torch.int64))
    return vals[-1]


class LUTDecoder:
    """decode(llr_cha, llr_msg) with (B, nvar) integer label inputs returns
    (bits (B, nvar) uint8, ok (B,) bool, iters (B,) int32); iters is the
    convergence iteration, max_iters for a frame that never converged."""

    def __init__(self, codec, device, early_exit: bool = True):
        self.codec = codec
        self.device = resolve_device(device)
        self.early_exit = early_exit
        g = codec.graph
        self.nvar = g.nvar
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.device)
        self._edge_var = t(g.var_llr_edge_expand())
        self._vn_degrees = [int(d) for d in g.vn_degrees]
        self._cn_degrees = [int(d) for d in g.cn_degrees]
        self._vn_edge_idx = {d: t(g.vn_edge_idx[d]) for d in self._vn_degrees}
        self._vn_node_idx = {d: t(g.vn_node_idx[d]) for d in self._vn_degrees}
        self._cn_edge_idx = {d: t(g.cn_edge_idx[d]) for d in self._cn_degrees}
        self._vn_loo = {d: t(leave_one_out_idx(d + 1, d)) for d in self._vn_degrees}
        self._cn_loo = {d: t(leave_one_out_idx(d, d)) for d in self._cn_degrees}

        # phantom completion edges: per phantom variable its real and its
        # phantom edges; the syndrome reads phantom (check, var) slots from
        # a zero column appended to the bits
        self._ph = []
        by_var: dict = {}
        for p in g.phantoms:
            by_var.setdefault(p["var"], []).append(p)
        starts = np.concatenate([[0], np.cumsum(g.dv_vec)])
        for v, plist in sorted(by_var.items()):
            ph_e = sorted(p["edge"] for p in plist)
            er = [e for e in range(starts[v], starts[v + 1]) if e not in ph_e]
            self._ph.append(dict(v=int(v), td=len(er), er=t(er), ph=t(ph_e)))
        self._ph_edges = (t(sorted(p["edge"] for p in g.phantoms))
                          if g.phantoms else None)
        ph_pairs = {(p["chk"], p["var"]) for p in g.phantoms}
        self._cn_var_idx_synd = {}
        for d in self._cn_degrees:
            idx = np.asarray(g.cn_var_idx[d]).copy()
            for r, c in enumerate(g.cn_node_idx[d]):
                for k in range(d):
                    if (int(c), int(idx[r, k])) in ph_pairs:
                        idx[r, k] = g.nvar
            self._cn_var_idx_synd[d] = t(idx)

        # trees -> programs (iterations that reuse a tree share its tables)
        self._prog_cache: dict = {}
        self._var_progs = {}  # (iteration, degree) -> (program, tables)
        self._chk_progs = {}
        ph_tds = sorted({p["td"] for p in self._ph})
        for ii in range(codec.max_iters):
            for d in self._vn_degrees + ph_tds:
                self._var_progs[ii, d] = self._compile(codec.var_tree(ii, d))
            if not codec.min_lut:
                for d in self._cn_degrees:
                    self._chk_progs[ii, d] = self._compile(codec.chk_tree(ii, d))
        self._ph_loo = {td: t(leave_one_out_idx(td + 1, td)) for td in ph_tds}

    def _compile(self, tree):
        key = id(tree)
        if key not in self._prog_cache:
            prog = tree_program(tree)
            tables = [torch.as_tensor(np.asarray(op.table, np.int64),
                                      device=self.device) for op in prog.ops]
            self._prog_cache[key] = (prog, tables)
        return self._prog_cache[key]

    # ------------------------------------------------------------------
    def _cn_pass(self, msgs, ii):
        nz = int(self.codec.Nq_Msg[ii]) // 2
        msgs = msgs.clone()
        if self._ph_edges is not None:  # pin: strongest positive
            msgs[:, self._ph_edges] = 2 * nz - 1
        for d in self._cn_degrees:
            idx = self._cn_edge_idx[d]
            m = msgs[:, idx]  # (B, m_d, d)
            if self.codec.min_lut:
                out = cn_minsum(m, nz)
            else:
                prog, tables = self._chk_progs[ii, d]
                out = eval_program(prog, tables, m[:, :, self._cn_loo[d]])
            msgs[:, idx] = out
        return msgs

    def _vn_pass(self, msgs, llr_cha, ii):
        # a phantom node's real c2v inputs, read before its degree group's
        # update overwrites them (the JAX class reads them after it, which
        # is harmless for true degree 1 only; decode_ref is the definition)
        ph_in = [msgs[:, p["er"]] for p in self._ph]
        for d in self._vn_degrees:
            idx = self._vn_edge_idx[d]
            inp = torch.cat([msgs[:, idx],
                             llr_cha[:, self._vn_node_idx[d]][..., None]], dim=-1)
            prog, tables = self._var_progs[ii, d]
            msgs[:, idx] = eval_program(prog, tables, inp[:, :, self._vn_loo[d]])
        for p, m in zip(self._ph, ph_in):  # true-degree update, real sockets
            td = p["td"]
            inp = torch.cat([m, llr_cha[:, p["v"]][:, None]], dim=-1)
            prog, tables = self._var_progs[ii, td]
            out = eval_program(prog, tables, inp[:, self._ph_loo[td]])  # (B, td)
            msgs[:, p["er"]] = out
            # phantom sockets mirror output 0 (unanimity-transparent)
            msgs[:, p["ph"]] = out[:, :1]
        return msgs

    def _hard_bits_unanimous(self, msgs, nz):
        B = msgs.shape[0]
        bits = torch.zeros((B, self.nvar), dtype=torch.uint8, device=msgs.device)
        unan = torch.ones(B, dtype=torch.bool, device=msgs.device)
        for d in self._vn_degrees:
            neg = msgs[:, self._vn_edge_idx[d]] < nz  # (B, n_d, d)
            unan &= (neg == neg[..., :1]).all(dim=-1).all(dim=-1)
            bits[:, self._vn_node_idx[d]] = neg[..., 0].to(torch.uint8)
        return bits, unan

    def _syndrome_ok(self, bits):
        ok = torch.ones(bits.shape[0], dtype=torch.bool, device=bits.device)
        bits = torch.cat([bits, torch.zeros_like(bits[:, :1])], dim=1)
        for d in self._cn_degrees:
            s = bits[:, self._cn_var_idx_synd[d]].to(torch.int32).sum(dim=-1) & 1
            ok &= (s == 0).all(dim=-1)
        return ok

    def _dec_pass(self, msgs, llr_cha):
        T = self.codec.max_iters
        bits = torch.zeros((msgs.shape[0], self.nvar), dtype=torch.uint8,
                           device=msgs.device)
        for d in self._vn_degrees:
            x = torch.cat([msgs[:, self._vn_edge_idx[d]],
                           llr_cha[:, self._vn_node_idx[d]][..., None]], dim=-1)
            prog, tables = self._var_progs[T - 1, d]
            bits[:, self._vn_node_idx[d]] = (
                eval_program(prog, tables, x) < 1).to(torch.uint8)
        for p in self._ph:  # true-degree decision tree
            x = torch.cat([msgs[:, p["er"]], llr_cha[:, p["v"]][:, None]], dim=-1)
            prog, tables = self._var_progs[T - 1, p["td"]]
            bits[:, p["v"]] = (eval_program(prog, tables, x) < 1).to(torch.uint8)
        return bits

    def __call__(self, llr_cha, llr_msg):
        T = self.codec.max_iters
        # the label tables below are int64: so are the labels they meet
        cha = as_labels(llr_cha, self.device, self.nvar).long()
        msgs = as_labels(llr_msg, self.device, self.nvar).long()[:, self._edge_var]
        B = cha.shape[0]
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        latched = torch.zeros((B, self.nvar), dtype=torch.uint8, device=self.device)
        iters = torch.full((B,), T, dtype=torch.int32, device=self.device)
        for ii in range(T):
            # converged frames are not frozen as in the JAX class: their
            # outputs are latched below and their later state is never read,
            # and a frozen frame's labels of an earlier, finer resolution
            # would index past the tables of a coarser iteration
            msgs = self._cn_pass(msgs, ii)
            if ii != T - 1:
                msgs = self._vn_pass(msgs, cha, ii)
            if self.early_exit and ii != T - 1:
                bits, unan = self._hard_bits_unanimous(
                    msgs, int(self.codec.Nq_Msg[ii + 1]) // 2)
                conv = unan & self._syndrome_ok(bits) & ~done
                latched = torch.where(conv[:, None], bits, latched)
                iters = torch.where(conv, torch.full_like(iters, ii + 1), iters)
                done = done | conv
        bits = self._dec_pass(msgs, cha)
        ok = done | self._syndrome_ok(bits)
        return torch.where(done[:, None], latched, bits), ok, iters
