"""Value-domain LUT decoder (the kernel path).

Port of lut_ldpc_tpu/decoder/arith_decoder.py ``ArithLUTDecoder`` with its
``_build_qc_pallas`` loop (:1093-1457, graphs with a quasi-cyclic plan) and
its ``_build_std_kernels`` loop (:863-1090, every other graph: PEG codes,
the unpermuted DVB-S2 matrix), as one eager loop over iterations:

- labels -> int16/float32 values through the spec's leaf tables;
- per iteration one CN pass (which also yields the syndrome of the input
  signs) and one VN pass (which also yields hard bits and sign
  unanimity), both from ``qc_kernels``: the ``*_qc_pass`` pair rolls
  circulants inside the kernel, the ``*_std_pass`` pair works on contiguous
  slot planes and the permutation is a row gather here, before each pass;
- the early-exit latch ``conv = unan_p & synd & (it >= 1) & ~done`` with
  bits_p / unan_p from the previous VN pass (:1285);
- the survivor funnel (:1318-1389): when the live count falls to the next
  width, the undecided frames (padded with finished ones) are gathered
  into a narrower batch by a stable sort of ``done``; the JAX loop's stop
  test becomes a host read of the live count before every iteration;
- raw mode returns the carry for the hybrid decoder's table tail; full
  specs finish with the decision trees and the output syndrome;
- ``resume`` is the continuation mode (``cont_from`` of both JAX loops):
  the loop starts at iteration k from per-edge values and a given early-exit
  state, for the mixed-precision decoders' float32 segment.

Messages stay in the standard slot-major grouped layout
(``GroupedLayout(slot_major=True, align=16)``), shape (rows, B).

Not ported here: phantom-completed graphs (ROADMAP A6) and the plain
value-domain path ``_build`` without kernels (A8).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from . import fast_layout
from . import qc_kernels as qk
from .arith import build_arith_spec
from .params import (arith_tensors, qc_tables, std_tables, torch_dtype,
                     vn_params)

__all__ = ["ArithLUTDecoder", "funnel_widths", "as_labels"]


def funnel_widths(B: int) -> list:
    """Stage widths for survivor compaction: [B, B/4, B/16], floored at
    512 frames (LUT_FUNNEL_MIN sets the floor, as in the JAX decoder)."""
    floor = int(os.environ.get("LUT_FUNNEL_MIN", "512"))
    widths = [B]
    for d in (4, 16):
        w = B // d
        if w >= floor and w < widths[-1]:
            widths.append(w)
    return widths


def as_labels(x, device: torch.device, nvar: int) -> torch.Tensor:
    """(B, nvar) integer labels on `device` as int64 (numpy arrays are
    copied there; a tensor on another device raises)."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"labels on {x.device}, decoder on {device}")
    else:
        x = torch.as_tensor(np.asarray(x), device=device)
    if x.dim() != 2 or x.shape[1] != nvar:
        raise ValueError(f"labels: shape {tuple(x.shape)}, expected (B, {nvar})")
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        raise TypeError(f"labels: dtype {x.dtype}, expected an integer type")
    return x.long()


def _tree_params(spec_tree):
    """Decision-tree ops as (operands, thr, levels, tie_lo, tie_hi) float32
    numpy parameters (select-chain emission; exact for integer specs since
    their sums stay below 2^24)."""
    return [(tuple(int(x) for x in op.operands),
             np.asarray(op.thresholds, np.float32),
             np.asarray(op.levels, np.float32),
             np.float32(op.tie_lo), np.float32(op.tie_hi))
            for op in spec_tree.ops]


class ArithLUTDecoder:
    """Full decoder from a complete spec; with a prefix spec (dec_trees
    None) it decodes the first spec.num_iters iterations and reports
    per-frame convergence.

    device: where the decoder's tensors live and its inputs must be.
    kernels: False routes CUDA tensors through the plain twins instead of
    the CUDA kernels (the comparison path); CPU tensors always take the
    twins."""

    def __init__(self, codec, device, early_exit: bool = True, spec=None,
                 kernels: bool = True):
        self.codec = codec
        self.device = resolve_device(device)
        self.early_exit = early_exit
        self.spec = spec if spec is not None else build_arith_spec(codec)
        self.is_prefix = self.spec.dec_trees is None
        if self.is_prefix and not early_exit:
            raise ValueError("a prefix decoder requires early_exit")
        if codec.graph.phantoms:
            raise NotImplementedError(
                "phantom-completed graphs (ROADMAP A6)")
        self.T = codec.max_iters
        self.S = self.spec.num_iters
        self.nvar = codec.graph.nvar
        self.dtype = torch_dtype(self.spec.dtype)
        self.kernels = kernels
        self.layout = fast_layout.GroupedLayout(codec.graph, slot_major=True,
                                                align=16)
        qc = getattr(codec.graph, "qc", None)
        self.plan = self.layout.qc_plan(qc) if qc is not None else None
        try:
            spec_di = [self.spec.degrees.index(blk.degree)
                       for blk in self.layout.vn_blocks]
        except ValueError:
            raise ValueError("arith spec degrees do not match graph blocks")
        self.tables = (qc_tables(self.plan, self.layout, self.device)
                       if self.plan is not None
                       else std_tables(self.layout, self.device))
        self.params = vn_params(self.spec, self.layout, self.device)
        self.ten = arith_tensors(self.spec, self.layout, self.device)
        self._dec = (None if self.is_prefix else
                     [_tree_params(self.spec.dec_trees[di]) for di in spec_di])

    # ------------------------------------------------------------------
    def _cn(self, m_vn):
        """VN-grouped v2c values -> (CN-grouped c2v values, syndrome)."""
        if self.plan is not None:
            fn = qk.cn_qc_pass if self.kernels else qk.cn_qc_pass_ref
            return fn(m_vn, self.tables)
        fn = qk.cn_std_pass if self.kernels else qk.cn_std_pass_ref
        return fn(m_vn.index_select(0, self.tables.perm_v2c), self.tables)

    def _vn(self, m_cn, vcha, it):
        """CN-grouped c2v values -> (VN-grouped v2c values, bits, unan)."""
        if self.plan is not None:
            fn = qk.vn_qc_pass if self.kernels else qk.vn_qc_pass_ref
            return fn(m_cn, vcha, it, self.params, self.tables)
        fn = qk.vn_std_pass if self.kernels else qk.vn_std_pass_ref
        return fn(m_cn.index_select(0, self.tables.perm_c2v), vcha, it,
                  self.params, self.tables)

    def _channel_values(self, llr_cha):
        """Grouped channel values (nvar_pad, B)."""
        cha = as_labels(llr_cha, self.device, self.nvar)
        return self.ten.leaf_cha[cha[:, self.ten.vn_nodes].T].contiguous()

    def _init(self, llr_cha, llr_msg):
        """Grouped channel values, and the loop state at iteration 0: every
        edge carries its variable's initial message value."""
        vcha = self._channel_values(llr_cha)
        msg = as_labels(llr_msg, self.device, self.nvar)
        v0 = self.ten.leaf_msg0[msg[:, self.ten.vn_nodes].T]
        m_vn = v0[self.ten.edge_node].contiguous()
        B = m_vn.shape[1]
        nvp = self.layout.nvar_pad
        dev = self.device
        return vcha, [
            m_vn,
            torch.zeros((nvp, B), dtype=torch.int8, device=dev),   # bits_p
            torch.zeros(B, dtype=torch.bool, device=dev),          # unan_p
            torch.zeros(B, dtype=torch.bool, device=dev),          # done
            torch.zeros((nvp, B), dtype=torch.int8, device=dev),   # latched
            torch.full((B,), self.T, dtype=torch.int32, device=dev)]

    def _loop(self, vcha, state, start: int = 0):
        """Iterations [start, S) with the early-exit latch and the funnel
        on state = [m_vn, bits_p, unan_p, done, latched, iters]; returns
        the state at loop exit."""
        B = state[0].shape[1]

        def step(state, vcha_s, it):
            m_vn, bits_p, unan_p, done, latched, iters = state
            state[0] = None  # the caller's reference: m_vn is dead after _cn
            m_cn, synd = self._cn(m_vn)
            del m_vn
            if self.early_exit:
                conv = unan_p & synd & ~done
                if it < 1:
                    conv = torch.zeros_like(conv)
                latched = torch.where(conv[None, :], bits_p, latched)
                iters = torch.where(conv, torch.full_like(iters, it), iters)
                done = done | conv
            m_vn, bits_p, unan_p = self._vn(m_cn, vcha_s, it)
            return [m_vn, bits_p, unan_p, done, latched, iters]

        if not (self.early_exit and self.S > 0):
            for it in range(start, self.S):
                state = step(state, vcha, it)
            return state

        widths = funnel_widths(B)
        it = start
        vcha_s = vcha
        stack = []  # per shrink: (survivor idx, full-width state)
        for si in range(len(widths)):
            nxt = widths[si + 1] if si + 1 < len(widths) else 0
            while it < self.S and int((~state[3]).sum()) > nxt:
                state = step(state, vcha_s, it)
                it += 1
            if nxt:
                # stable ascending sort of done: the first nxt columns hold
                # every undecided frame, padded with finished ones
                idx = torch.argsort(state[3].to(torch.uint8), stable=True)[:nxt]
                stack.append((idx, state))
                state = [s.index_select(s.dim() - 1, idx).contiguous()
                         for s in state]
                vcha_s = vcha_s.index_select(1, idx).contiguous()
        for idx, full in reversed(stack):
            merged = []
            for f, s in zip(full, state):
                f = f.clone()
                f.index_copy_(f.dim() - 1, idx, s)
                merged.append(f)
            state = merged
        return state

    def raw_carry(self, llr_cha, llr_msg):
        """(m_vn (E_vn, B) values, done, latched (nvar_pad, B) uint8, iters)
        at loop exit, before the post-loop convergence check: the hand-off
        to HybridLUTDecoder's label-domain tail.  Padding rows of m_vn are
        unspecified."""
        if not self.early_exit:
            raise ValueError("raw carry requires early_exit")
        vcha, state = self._init(llr_cha, llr_msg)
        m_vn, _, _, done, latched, iters = self._loop(vcha, state)
        return m_vn, done, latched.to(torch.uint8), iters

    def __call__(self, llr_cha, llr_msg):
        """Labels (B, nvar) -> (bits (B, nvar) uint8, ok (B,) bool,
        iters (B,) int32); a prefix decoder's ok is its convergence flag."""
        vcha, state = self._init(llr_cha, llr_msg)
        return self._finish(vcha, self._loop(vcha, state))

    def resume(self, k: int, llr_cha, m_vn, bits_p, unan_p, done, latched,
               iters, raw: bool = False):
        """Continuation segment: iterations [k, S) from per-edge values
        m_vn ((E_vn, B), this spec's iteration-k input table entries, std
        grouped layout) and the early-exit state at the segment boundary.
        bits_p / unan_p must be the sign data of the previous segment's
        final VN outputs, so that the first latch here equals the one a
        single decoder would take.  Returns what ``__call__`` returns, or
        with raw=True what ``raw_carry`` returns."""
        if not self.early_exit:
            raise ValueError("resume requires early_exit")
        if not 0 <= k <= self.S:
            raise ValueError(f"resume at iteration {k} outside [0, {self.S}]")
        vcha = self._channel_values(llr_cha)
        state = self._loop(vcha, [
            m_vn.to(self.dtype).contiguous(), bits_p.to(torch.int8), unan_p,
            done, latched.to(torch.int8), iters], start=k)
        if raw:
            m_vn, _, _, done, latched, iters = state
            return m_vn, done, latched.to(torch.uint8), iters
        return self._finish(vcha, state)

    def _finish(self, vcha, state):
        """Post-loop convergence check, decision trees and output syndrome
        (arith_decoder.py:1403-1455)."""
        m_vn, bits_p, unan_p, done, latched, iters = state
        del state
        m_cn, synd = self._cn(m_vn)
        del m_vn
        if self.early_exit and self.S >= 1:
            conv = unan_p & synd & ~done
            latched = torch.where(conv[None, :], bits_p, latched)
            iters = torch.where(conv, torch.full_like(iters, self.S), iters)
            done = done | conv
        node_pos = self.ten.vn_node_pos
        if self.is_prefix:
            return latched[node_pos].T.to(torch.uint8), done, iters
        dec_bits = self._decision(m_cn, vcha)
        bits_grp = torch.where(done[None, :], latched, dec_bits)
        ok = done | self._syndrome_ok(bits_grp)
        return bits_grp[node_pos].T.to(torch.uint8), ok, iters

    # ------------------------------------------------------------------
    def _decision(self, m_cn, vcha):
        """Decision trees on the final c2v values (arith_decoder.py:1414-1436):
        (nvar_pad, B) int8 hard bits."""
        B = m_cn.shape[1]
        m_fin = m_cn[self.ten.perm_c2v]
        out = []
        for bi, blk in enumerate(self.layout.vn_blocks):
            d, n, e0 = blk.degree, blk.n_pad, blk.edge_start
            m = m_fin[e0 : e0 + n * d].reshape(d, n, B).to(torch.float32)
            cha = vcha[blk.node_start : blk.node_start + n].to(torch.float32)
            vals = [m[j] for j in range(d)] + [cha]
            for operands, thr, lev, tlo, thi in self._dec[bi]:
                s = vals[operands[0]]
                for sl in operands[1:]:
                    s = s + vals[sl]
                o = torch.full_like(s, float(lev[0]))
                for t in range(len(thr)):
                    o = torch.where(s >= float(thr[t]), float(lev[t + 1]), o)
                tie = torch.where(vals[operands[-1]] < 0, float(tlo), float(thi))
                vals.append(torch.where(s == 0, tie, o))
            out.append((vals[-1] < 0).to(torch.int8))
        return torch.cat(out, dim=0)

    def _syndrome_ok(self, bits_grp):
        """Per-frame parity of the decided bits over every real check."""
        B = bits_grp.shape[1]
        edge_bits = bits_grp[self.ten.cn_var_pos].to(torch.int32)
        ok = torch.ones(B, dtype=torch.bool, device=bits_grp.device)
        pos = 0
        for bi, blk in enumerate(self.layout.cn_blocks):
            d, n = blk.degree, blk.n_pad
            s = edge_bits[pos : pos + n * d].reshape(d, n, B).sum(dim=0) & 1
            ok &= ((s == 0) | self.ten.cn_padmask[bi][:, None]).all(dim=0)
            pos += n * d
        return ok
