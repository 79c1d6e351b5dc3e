"""Label-domain table decoder and the decoder ladder.

``FastLUTDecoder`` ports lut_ldpc_tpu/decoder/fast_decoder.py (:109): int8
labels in (B, E) node-major grouped layout, two permutation gathers per
iteration, min-sum CN on labels or the codec's CN LUT trees, VN updates
through composed leave-one-out tables (one gather per node) or per-op tree
programs.  The JAX ``lax.scan`` over iterations is a Python loop here;
``tail(start, ...)`` is the continuation from iteration ``start`` that
HybridLUTDecoder hands its value-domain state to.  This is gathers on labels
in plain torch; the JAX package has no Pallas kernel for it either.

``make_decoder`` keeps the JAX ladder (fast_decoder.py:50-106) and picks
the class the JAX package picks for the same codec where its kernels run
(on a TPU): this package always has a kernel path.  Its last rung is the
general ``LUTDecoder``, with the JAX package's warning for a large
phantom-completed codec.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..device import resolve_device
from . import fast_layout
from .arith import ArithBuildError, build_arith_spec
from .arith_decoder import ArithLUTDecoder, as_labels
from .lut_decoder import LUTDecoder, cn_minsum, eval_program
from .params import fast_tables

__all__ = ["FastLUTDecoder", "make_decoder"]


def make_decoder(codec, device, early_exit: bool = True):
    """Fastest provably-equivalent decoder for this codec, by the JAX
    package's order: full int16 arithmetic, mixed int16/f32 arithmetic,
    full f32 arithmetic, hybrid prefix + table tail, table decoder,
    general table decoder."""
    from .hybrid import HybridLUTDecoder, MixedArithDecoder

    try:  # int16 halves traffic when exact over the whole budget
        spec = build_arith_spec(codec, dtype=np.int16)
        return ArithLUTDecoder(codec, device, early_exit=early_exit, spec=spec)
    except ArithBuildError:
        pass  # exactness not proven for this codec/dtype: next rung
    if early_exit:
        try:  # int16 front segment + full-f32 arithmetic finish
            return MixedArithDecoder(codec, device)
        except ArithBuildError:
            pass  # any other error is a genuine fault and propagates
    try:
        spec = build_arith_spec(codec, dtype=np.float32)
        return ArithLUTDecoder(codec, device, early_exit=early_exit, spec=spec)
    except ArithBuildError:
        pass
    if early_exit:
        try:
            return HybridLUTDecoder(codec, device)
        except (ArithBuildError, ValueError):
            pass
    if len(set(int(x) for x in codec.Nq_Msg)) == 1:
        try:
            return FastLUTDecoder(codec, device, early_exit=early_exit)
        except ValueError:
            pass
    if (getattr(codec.graph, "qc_phantoms", ()) and codec.max_iters > 20
            and codec.nvar > 10000):
        warnings.warn(
            f"no arithmetic spec validates for this phantom-completed codec; "
            f"falling back to the general table decoder ({codec.max_iters} "
            f"iterations at N={codec.nvar} run slowly): consider the "
            f"unpermuted realization or a design sigma whose f32 spec "
            f"validates", stacklevel=2)
    return LUTDecoder(codec, device, early_exit=early_exit)


class FastLUTDecoder:
    def __init__(self, codec, device, early_exit: bool = True):
        if getattr(codec.graph, "qc_phantoms", ()):
            raise ValueError("phantom-completed graphs: only the arithmetic "
                             "decoders implement pinned-edge semantics")
        if len(set(int(x) for x in codec.Nq_Msg)) != 1:
            raise ValueError("fast decoder needs uniform Nq_Msg")
        self.codec = codec
        self.device = resolve_device(device)
        self.early_exit = early_exit
        maxres = max(int(codec.Nq_Msg.max()), int(codec.Nq_Cha))
        self.msg_dtype = torch.int8 if maxres <= 127 else torch.int16
        self.Nq = int(codec.Nq_Msg[0])
        self.nz = self.Nq // 2
        self.T = codec.max_iters
        self.nvar = codec.graph.nvar
        self.layout = fast_layout.GroupedLayout(codec.graph)
        self.tab = fast_tables(codec, self.layout, self.Nq, self.device)

    # ------------------------------------------------------------------
    def _blocks_of(self, m, blocks):
        """(B, E) -> per-block (B, n, d) views."""
        return [m[:, b.edge_start : b.edge_start + b.num_nodes * b.degree]
                .reshape(m.shape[0], b.num_nodes, b.degree) for b in blocks]

    def _vn_update_block(self, bi, m, cha, it):
        """m (B, n, d) labels, cha (B, n) channel labels -> (B, n, d)."""
        d = self.layout.vn_blocks[bi].degree
        tab = self.tab
        if tab.var_kind[bi] == "composed":
            idx = ((m.to(torch.int64) * tab.bases[d].to(torch.int64)).sum(dim=-1)
                   + cha.to(torch.int64) * (self.Nq ** d))
            packed = tab.var_xs[bi][it][idx]
            shifts = torch.arange(d, device=m.device, dtype=torch.int32) * tab.out_bits
            outs = (packed[..., None] >> shifts) & ((1 << tab.out_bits) - 1)
            return outs.to(self.msg_dtype)
        inp = torch.cat([m, cha[..., None].to(self.msg_dtype)], dim=-1)
        x = inp[:, :, tab.vn_loo[d]]  # (B, n, d, d)
        tables = [t[it] for t in tab.var_xs[bi]]
        return eval_program(tab.var_progs[bi], tables, x).to(self.msg_dtype)

    def _cn_update(self, m_cn, it):
        """Full CN pass of iteration `it` on the CN-grouped labels: min-sum,
        or the codec's CN LUT trees (fast_decoder.py:292)."""
        tab = self.tab
        outs = []
        for ci, m in enumerate(self._blocks_of(m_cn, self.layout.cn_blocks)):
            if self.codec.min_lut:
                out = cn_minsum(m, self.nz)
            else:
                d = self.layout.cn_blocks[ci].degree
                out = eval_program(tab.chk_progs[ci],
                                   [t[it] for t in tab.chk_xs[ci]],
                                   m[:, :, tab.cn_loo[d]]).to(self.msg_dtype)
            outs.append(out.reshape(m.shape[0], -1))
        return torch.cat(outs, dim=1)

    def _convergence(self, m_vn, m_cn):
        """(bits (B, nvar) uint8 grouped, conv (B,) bool) from unanimity of
        the VN-grouped signs and parity of the CN-grouped signs."""
        B = m_vn.shape[0]
        bits = []
        unan = torch.ones(B, dtype=torch.bool, device=m_vn.device)
        for m in self._blocks_of(m_vn, self.layout.vn_blocks):
            neg = m < self.nz
            unan &= (neg == neg[..., :1]).all(dim=-1).all(dim=-1)
            bits.append(neg[..., 0].to(torch.uint8))
        synd = torch.ones(B, dtype=torch.bool, device=m_vn.device)
        for m in self._blocks_of(m_cn, self.layout.cn_blocks):
            s = (m < self.nz).to(torch.int32).sum(dim=-1) & 1
            synd &= (s == 0).all(dim=-1)
        return torch.cat(bits, dim=1), unan & synd

    def cha_blocks(self, llr_cha):
        grp = llr_cha[:, self.tab.vn_nodes].to(self.msg_dtype)
        return [grp[:, b.node_start : b.node_start + b.num_nodes]
                for b in self.layout.vn_blocks]

    # ------------------------------------------------------------------
    def __call__(self, llr_cha, llr_msg):
        cha = as_labels(llr_cha, self.device, self.nvar)
        msg = as_labels(llr_msg, self.device, self.nvar)
        B = cha.shape[0]
        msg_grp = msg[:, self.tab.vn_nodes].to(self.msg_dtype)
        # initial messages: every edge carries its variable's label
        m_vn = torch.cat([
            msg_grp[:, b.node_start : b.node_start + b.num_nodes, None]
            .expand(B, b.num_nodes, b.degree).reshape(B, -1)
            for b in self.layout.vn_blocks], dim=1)
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        latched = torch.zeros((B, self.nvar), dtype=torch.uint8, device=self.device)
        iters = torch.full((B,), self.T, dtype=torch.int32, device=self.device)
        return self.tail(0, m_vn, self.cha_blocks(cha), done, latched, iters)

    def tail(self, start, m_vn, cha_blocks, done, latched, iters):
        """Label-domain decode from iteration `start` (fast_decoder.py:359):
        iterations start..T-2, then the final CN pass, decision trees and
        output syndrome.  m_vn (B, E) labels, latched (B, nvar) grouped
        bits.  Returns (bits (B, nvar) uint8, ok, iters)."""
        T = self.T
        tab = self.tab
        B = m_vn.shape[0]
        for it in range(start, T - 1):
            m_cn = m_vn[:, tab.perm_v2c]
            if self.early_exit:
                bits, conv = self._convergence(m_vn, m_cn)
                conv = conv & ~done if it >= 1 else torch.zeros_like(done)
                latched = torch.where(conv[:, None], bits, latched)
                iters = torch.where(conv, torch.full_like(iters, it), iters)
                done = done | conv
            m_new = self._cn_update(m_cn, it)[:, tab.perm_c2v]
            outs = []
            for bi, (m, cha) in enumerate(zip(
                    self._blocks_of(m_new, self.layout.vn_blocks), cha_blocks)):
                outs.append(self._vn_update_block(bi, m, cha, it).reshape(B, -1))
            m_vn = torch.where(done[:, None], m_vn, torch.cat(outs, dim=1))

        # final iteration: check the VN output of step T-2, then CN + decision
        m_cn = m_vn[:, tab.perm_v2c]
        if self.early_exit and T >= 2:
            bits, conv = self._convergence(m_vn, m_cn)
            conv = conv & ~done
            latched = torch.where(conv[:, None], bits, latched)
            iters = torch.where(conv, torch.full_like(iters, T - 1), iters)
            done = done | conv
        m_fin = self._cn_update(m_cn, T - 1)[:, tab.perm_c2v]

        dec_bits = []
        for bi, (m, cha) in enumerate(zip(
                self._blocks_of(m_fin, self.layout.vn_blocks), cha_blocks)):
            d = self.layout.vn_blocks[bi].degree
            if tab.dec_kind[bi] == "composed":
                idx = ((m.to(torch.int64) * tab.bases[d].to(torch.int64)).sum(dim=-1)
                       + cha.to(torch.int64) * (self.Nq ** d))
                out = tab.dec_tab[bi][idx]
            else:
                prog, tabs = tab.dec_progs[bi]
                out = eval_program(prog, tabs,
                                        torch.cat([m, cha[..., None]], dim=-1))
            dec_bits.append((out < 1).to(torch.uint8))
        bits_grp = torch.where(done[:, None], latched, torch.cat(dec_bits, dim=1))

        # final syndrome on the decision output
        edge_bits = bits_grp[:, tab.cn_var_pos].to(torch.int32)
        s_ok = torch.ones(B, dtype=torch.bool, device=m_vn.device)
        pos = 0
        for blk in self.layout.cn_blocks:
            d, n = blk.degree, blk.num_nodes
            s = edge_bits[:, pos : pos + n * d].reshape(B, n, d).sum(dim=-1) & 1
            s_ok &= (s == 0).all(dim=-1)
            pos += n * d
        return bits_grp[:, tab.vn_node_pos], done | s_ok, iters
