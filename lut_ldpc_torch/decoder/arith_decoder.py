"""Value-domain LUT decoder (the kernel path).

Port of lut_ldpc_tpu/decoder/arith_decoder.py ``ArithLUTDecoder`` with its
three loops as one eager loop over iterations whose CN and VN passes come
from one of three places:

- ``qc``, the ``_build_qc_pallas`` loop (:1093-1457, graphs with a
  quasi-cyclic plan): ``cn_qc_pass`` / ``vn_qc_pass`` roll circulants inside
  the kernel;
- ``std``, the ``_build_std_kernels`` loop (:863-1090, every other graph:
  PEG codes, the unpermuted DVB-S2 matrix): ``cn_std_pass`` /
  ``vn_std_pass`` work on contiguous slot planes; the CN pass reads and
  writes the VN-grouped arrays, so the two row gathers of the JAX loop
  (``jnp.take`` before and after its CN kernel) are inside its loads and
  stores and every array of the loop is VN-grouped;
- ``blocks``, the plain ``_build`` loop (:621-823): one ``cn_block_pass``
  per check degree block on the CN-grouped v2c array (a torch
  ``index_select`` by perm_v2c before it), all writing one CN-grouped c2v
  array, then ``vn_blocks_pass`` (``block_kernels``): one generated kernel
  per variable degree block, which reads the CN-grouped c2v array through
  perm_c2v (the JAX loop's second gather folded into its loads) and writes
  one VN-grouped array and one bits array.  It is taken where neither
  kernel loop applies (a phantom node whose true degree is not 1) or when
  the constructor is given ``loop="blocks"``.

Around the passes, shared by the three (``loop_glue``: one kernel each on
the card):

- labels -> int16/float32 values through the spec's leaf tables, the
  grouped channel values and every edge's iteration-0 value in one
  ``init_values`` launch;
- the early-exit latch ``conv = unan_p & synd & (it >= 1) & ~done`` with
  bits_p / unan_p from the previous VN pass (:1285) and synd from the CN
  pass's input signs: ``loop_state`` right after the CN pass computes conv
  and updates ``iters`` and ``done`` in place, and ``latch`` copies bits_p
  into ``latched`` in place for the frames with conv, before the VN pass;
- the survivor funnel (:1318-1389): when the live count falls to the next
  width, the undecided frames (padded with finished ones) are gathered
  into a narrower batch by a stable sort of ``done``, and merged back in
  place at loop exit; the JAX loop's stop test becomes a host read of the
  live count after every iteration, which ``loop_state`` copies to pinned
  host memory behind an event: the host waits for it while the VN pass
  runs, so the queue does not drain (the count is exact, as ``done`` is
  final once ``loop_state`` ran);
- raw mode returns the carry for the hybrid decoder's table tail; full
  specs finish with the decision trees and the output syndrome;
- ``resume`` is the continuation mode (``cont_from`` of both JAX loops):
  the loop starts at iteration k from per-edge values and a given early-exit
  state, for the mixed-precision decoders' float32 segment.

Phantom completion edges (core/qc.py; the permuted DVB-S2 matrix has one)
keep the pinned-edge semantics of ``decode_ref`` (:122-226): a phantom v2c
row holds the strongest positive value at every CN pass, which min-sum
ignores; the phantom node updates with the trees of its TRUE degree over its
real sockets; the output syndrome skips phantom pairs.  The kernel loops
cover true degree 1: before the VN pass the node's phantom input rows take
its one real c2v input, so its unanimity lane is trivially true, and after
the pass its real row takes the channel-only tree's output (plain torch on
one (B,) row).  The block loop covers any true degree and recomputes bits
and unanimity from the repaired rows.

Messages stay in the standard slot-major grouped layout
(``GroupedLayout(slot_major=True, align=16)``), shape (rows, B), in all
three loops, so the phantom rows index the arrays directly.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from . import block_kernels as bk
from . import fast_layout
from . import loop_glue as lg
from . import qc_kernels as qk
from . import vn_codegen
from .arith import ArithBuildError, build_arith_spec
from .layout import leave_one_out_idx
from .params import (arith_tensors, qc_tables, std_tables, torch_dtype,
                     vn_params)

__all__ = ["ArithLUTDecoder", "funnel_widths", "as_labels", "seam_bits_unan"]


def funnel_widths(B: int) -> list:
    """Stage widths for survivor compaction: [B, B/4, B/16], floored at
    512 frames.  As in the JAX decoder, LUT_FUNNEL_MIN sets the floor and
    LUT_FUNNEL the divisors ("0", "off" or "none": no funnel; else a
    comma-separated list such as "4,16")."""
    env = os.environ.get("LUT_FUNNEL", "")
    if env.lower() in ("0", "off", "none"):
        return [B]
    divs = [int(x) for x in env.split(",") if x.strip()] if env else [4, 16]
    floor = int(os.environ.get("LUT_FUNNEL_MIN", "512"))
    widths = [B]
    for d in divs:
        w = B // d
        if w >= floor and w < widths[-1]:
            widths.append(w)
    return widths


def as_labels(x, device: torch.device, nvar: int) -> torch.Tensor:
    """(B, nvar) integer labels on `device`, int32 and int64 as they come,
    other integer types as int64 (numpy arrays are copied there; a tensor on
    another device raises)."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"labels on {x.device}, decoder on {device}")
    else:
        x = torch.as_tensor(np.asarray(x), device=device)
    if x.dim() != 2 or x.shape[1] != nvar:
        raise ValueError(f"labels: shape {tuple(x.shape)}, expected (B, {nvar})")
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        raise TypeError(f"labels: dtype {x.dtype}, expected an integer type")
    return x if x.dtype in (torch.int32, torch.int64) else x.long()


def seam_bits_unan(layout, m_edges: torch.Tensor):
    """Hard decisions (nvar_pad, B) int8 and per-frame sign unanimity from
    std-grouped per-edge VN-output values: the data the VN pass emits,
    recomputed from the array (at a precision seam, where re-embedding
    preserves signs, hybrid.py:69; after phantom rows were repaired in the
    block loop, arith_decoder.py:626-636).  Padding rows take no part in the
    unanimity."""
    B = m_edges.shape[1]
    bits = []
    unan = torch.ones(B, dtype=torch.bool, device=m_edges.device)
    for blk in layout.vn_blocks:
        d, n, e0 = blk.degree, blk.n_pad, blk.edge_start
        neg = m_edges[e0 : e0 + n * d].reshape(d, n, B) < 0
        unan &= (neg == neg[:1])[:, : blk.num_nodes].all(dim=0).all(dim=0)
        bits.append(neg[0].to(torch.int8))
    return torch.cat(bits, dim=0), unan


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a and b hold the same memory."""
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


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
    twins.
    loop: "auto" takes the QC kernels on a graph with a quasi-cyclic plan,
    the std kernels on any other, and the per-degree-block loop where a
    phantom node's true degree is not 1; "blocks" takes the block loop on
    any graph (what LUT_LDPC_NO_STD_KERNELS and a non-TPU platform do to
    the JAX decoder)."""

    def __init__(self, codec, device, early_exit: bool = True, spec=None,
                 kernels: bool = True, loop: str = "auto"):
        if loop not in ("auto", "blocks"):
            raise ValueError(f"loop {loop!r}: expected 'auto' or 'blocks'")
        self.codec = codec
        self.device = resolve_device(device)
        self.early_exit = early_exit
        self.spec = spec if spec is not None else build_arith_spec(codec)
        self.is_prefix = self.spec.dec_trees is None
        if self.is_prefix and not early_exit:
            raise ValueError("a prefix decoder requires early_exit")
        self.T = codec.max_iters
        self.S = self.spec.num_iters
        self.nvar = codec.graph.nvar
        self.dtype = torch_dtype(self.spec.dtype)
        self.kernels = kernels
        self.layout = fast_layout.GroupedLayout(codec.graph, slot_major=True,
                                                align=16)
        self._build_phantoms()
        qc = getattr(codec.graph, "qc", None)
        plan = self.layout.qc_plan(qc) if qc is not None else None
        # the kernel loops' equal-inputs trick covers true degree 1 only
        if loop == "blocks" or any(p["td"] != 1 for p in self._ph):
            self.loop = "blocks"
        else:
            self.loop = "qc" if plan is not None else "std"
        self.plan = plan if self.loop == "qc" else None
        self.tables = (qc_tables(self.plan, self.layout, self.device)
                       if self.plan is not None
                       else std_tables(self.layout, self.device))
        # classes of the layout blocks, then of the phantoms' true degrees
        blocks = self.layout.vn_blocks
        true_degs = sorted({p["td"] for p in self._ph})
        for p in self._ph:
            p["cls"] = len(blocks) + true_degs.index(p["td"])
        self.params = vn_params(self.spec, self.layout, self.device,
                                extra_degrees=true_degs)
        self.ten = arith_tensors(self.spec, self.layout, self.device)
        spec_di = [self.spec.degrees.index(d)
                   for d in [blk.degree for blk in blocks] + true_degs]
        self._dec = (None if self.is_prefix else
                     [_tree_params(self.spec.dec_trees[di]) for di in spec_di])
        self._init_tab = lg.init_table(
            self.layout, [r for p in self._ph for r in p["rows_ph"].tolist()],
            self.device)
        self._live = lg.LiveCount(self.device)
        self._progs = None
        if self.loop == "blocks":
            self._progs = [self._block_program(bi, spec_di[bi])
                           for bi in range(len(blocks))]
        if kernels and self.device.type == "cuda":
            # the generated VN kernels of the spec or of the block programs:
            # built (or found) here, not inside the first launch
            if self.loop == "blocks":
                vn_codegen.block_library(self._progs, self.dtype).handle()
            else:
                vn_codegen.library(self.params, self.dtype, self.loop).handle()

    # ------------------------------------------------------------------
    def _build_phantoms(self):
        """Static bookkeeping for phantom completion edges
        (arith_decoder.py:122-180): per phantom-completed variable its
        grouped node row, true degree, and the rows of its phantom and real
        sockets in the VN-grouped (rows_*) and CN-grouped (cn_rows_*) edge
        arrays, as index tensors (`real`: the real rows as a list)."""
        lay = self.layout
        self._ph = []
        by_var: dict = {}
        for p in self.codec.graph.phantoms:
            by_var.setdefault(p["var"], []).append(p)
        perm_c2v = np.asarray(lay.perm_c2v)
        idx = lambda rows: torch.as_tensor(np.asarray(rows, np.int64),
                                           device=self.device)
        for v, plist in sorted(by_var.items()):
            node_row = int(lay.vn_node_pos[v])
            blk = next(b for b in lay.vn_blocks
                       if b.node_start <= node_row < b.node_start + b.n_pad)
            rows = [blk.edge_start + k * blk.n_pad + node_row - blk.node_start
                    for k in range(blk.degree)]
            ph_slots = sorted(p["var_slot"] for p in plist)
            real = [rows[k] for k in range(blk.degree) if k not in ph_slots]
            if not real:
                raise ArithBuildError("phantom node with no real socket")
            if len(real) not in self.spec.degrees:
                raise ArithBuildError(
                    f"spec lacks the true degree-{len(real)} trees of a phantom "
                    "node (design the codec on the phantom graph)")
            ph = [rows[k] for k in ph_slots]
            self._ph.append(dict(
                node_row=node_row, td=len(real), real=real, rows_ph=idx(ph),
                rows_real=idx(real), cn_rows_ph=idx(perm_c2v[ph]),
                cn_rows_real=idx(perm_c2v[real])))
        # the strongest positive value: min-sum is neutral to it
        self._pin = (32767 if self.dtype == torch.int16
                     else float(np.finfo(np.float32).max))
        if self._ph:
            self._rows_ph = torch.cat([p["rows_ph"] for p in self._ph])
            self._cn_rows_ph = torch.cat([p["cn_rows_ph"] for p in self._ph])

    def _block_program(self, bi, di):
        """The block loop's packed VN tree of layout block bi (spec row di):
        plain thresholds and levels of every iteration, the way
        examples/profile_pallas.py hands them to the TPU kernel."""
        trees = [self.spec.var_trees[it][di] for it in range(self.S)]
        prm = [[dict(thr=op.thresholds, levels=op.levels, tie_lo=op.tie_lo,
                     tie_hi=op.tie_hi) for op in tree.ops] for tree in trees]
        d = self.layout.vn_blocks[bi].degree
        return bk.vn_block_program(trees[0], prm, leave_one_out_idx(d + 1, d),
                                   self.params.classes[bi].use_tot, self.device)

    # ------------------------------------------------------------------
    def _cn(self, m_vn):
        """VN-grouped v2c values -> (c2v values, syndrome): CN-grouped on
        the QC and the block loop, VN-grouped on the std loop.  Phantom rows
        of m_vn are pinned by ``_init`` and ``_vn``."""
        if self.loop == "qc":
            fn = qk.cn_qc_pass if self.kernels else qk.cn_qc_pass_ref
            return fn(m_vn, self.tables)
        if self.loop == "std":
            fn = qk.cn_std_pass if self.kernels else qk.cn_std_pass_ref
            return fn(m_vn, self.tables)
        m_cn = m_vn.index_select(0, self.tables.perm_v2c)
        fn = bk.cn_block_pass if self.kernels else bk.cn_block_pass_ref
        B = m_cn.shape[1]
        out, synd = torch.empty_like(m_cn), None
        for blk in self.layout.cn_blocks:
            d, n, e0 = blk.degree, blk.n_pad, blk.edge_start
            _, ok = fn(m_cn[e0 : e0 + n * d].view(d, n, B), blk.num_nodes,
                       out=out[e0 : e0 + n * d].view(d, n, B))
            synd = ok if synd is None else synd & ok
        return out, synd

    def _vn(self, m_cn, vcha, it):
        """c2v values as ``_cn`` gives them -> (VN-grouped v2c values, bits,
        unan), phantom nodes repaired and their phantom rows pinned."""
        if self.loop == "qc":
            for p in self._ph:  # m_cn is this step's own array
                m_cn[p["cn_rows_ph"]] = m_cn[p["cn_rows_real"][0]].clone()
            fn = qk.vn_qc_pass if self.kernels else qk.vn_qc_pass_ref
            m_new = None
            m_vn, bits, unan = fn(m_cn, vcha, it, self.params, self.tables)
        elif self.loop == "std":
            m_new = m_cn  # VN-grouped already; this step's own array
            for p in self._ph:
                m_new[p["rows_ph"]] = m_new[p["rows_real"][0]].clone()
            fn = qk.vn_std_pass if self.kernels else qk.vn_std_pass_ref
            m_vn, bits, unan = fn(m_new, vcha, it, self.params, self.tables)
        else:
            fn = bk.vn_blocks_pass if self.kernels else bk.vn_blocks_pass_ref
            m_vn, bits, unan = fn(m_cn, vcha, it, self._progs, self.tables)
        if not self._ph:
            return m_vn, bits, unan
        with torch.profiler.record_function("lut::phantom_rows"):
            for p in self._ph:
                # true-degree outputs over the real sockets (for true degree
                # 1 the tree reads the channel alone); the block loop reads
                # them in the CN-grouped array
                if p["td"] == 1:
                    msgs = []
                elif self.loop == "blocks":
                    msgs = list(m_cn.index_select(0, p["cn_rows_real"]))
                else:
                    msgs = [m_new[r] for r in p["real"]]
                outs = self._ph_node_outputs(p, msgs, vcha[p["node_row"]], it)
                m_vn[p["rows_real"]] = torch.stack(outs)
                if self.loop == "blocks":  # phantom sockets mirror output 0
                    m_vn[p["rows_ph"]] = outs[0]
                else:
                    bits[p["node_row"]] = (outs[0] < 0).to(bits.dtype)
            if self.loop == "blocks":
                bits, unan = seam_bits_unan(self.layout, m_vn)
            m_vn[self._rows_ph] = self._pin
        return m_vn, bits, unan

    def _ph_node_outputs(self, p, msgs, cha_row, it):
        """True-degree leave-one-out outputs of one phantom node
        (arith_decoder.py:190): msgs the td real c2v rows in slot order,
        cha_row its channel row; td output rows in the message dtype."""
        cls = self.params.classes[p["cls"]]
        prm = self.params.prm[it]
        msgs = [m.to(torch.float32) for m in msgs]
        cha_row = cha_row.to(torch.float32)
        return [qk.eval_vn_tree(cls, msgs[:i] + msgs[i + 1 :] + [cha_row],
                                prm).to(self.dtype)
                for i in range(p["td"])]

    def _values(self, llr_cha, llr_msg=None):
        """Grouped channel values (nvar_pad, B), and with message labels
        the iteration-0 edge values (E_vn, B) (every edge its variable's
        initial message value, phantom rows the pin), else None: one
        ``init_values`` launch, the kernel or (``kernels=False``, CPU) its
        plain version."""
        cha = as_labels(llr_cha, self.device, self.nvar).contiguous()
        msg = (None if llr_msg is None
               else as_labels(llr_msg, self.device, self.nvar).contiguous())
        fn = lg.init_values if self.kernels else lg.init_values_ref
        return fn(cha, msg, self._init_tab, self.ten.leaf_cha, self.ten.leaf_msg0,
                  self._pin, self.layout.num_edges_vn)

    def _init(self, llr_cha, llr_msg):
        """Grouped channel values, and the loop state at iteration 0."""
        vcha, m_vn = self._values(llr_cha, llr_msg)
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

    def _latch(self, unan_p, synd, done, iters, bits_p, latched, it, live=None):
        """The early-exit state after iteration `it`'s CN pass, in place on
        done, iters and latched: ``loop_state`` and ``latch``, or
        (``kernels=False``) their plain versions, the live count read
        directly."""
        if self.kernels:
            conv = lg.loop_state(unan_p, synd, done, iters, it, live)
            if it >= 1:
                lg.latch(conv, bits_p, latched)
            return
        conv = lg.loop_state_ref(unan_p, synd, done, iters, it)
        lg.latch_ref(conv, bits_p, latched)
        if live is not None:
            live.value = int((~done).sum())

    def _loop(self, vcha, state, start: int = 0, live: int | None = None,
              borrowed=()):
        """Iterations [start, S) with the early-exit latch and the funnel
        on state = [m_vn, bits_p, unan_p, done, latched, iters]; returns
        the state at loop exit.  done, latched and iters are updated in
        place; live: the count of frames not done at entry (default: all);
        borrowed: tensors of the state that are the caller's (copied before
        a funnel merge would write them)."""
        B = state[0].shape[1]

        def step(state, vcha_s, it, live=None):
            m_vn, bits_p, unan_p, done, latched, iters = state
            state[0] = None  # the caller's reference: m_vn is dead after _cn
            m_cn, synd = self._cn(m_vn)
            del m_vn
            if self.early_exit:
                # done and iters final for this step: the live count's copy
                # is queued here, before the VN pass
                self._latch(unan_p, synd, done, iters, bits_p, latched, it, live)
            m_vn, bits_p, unan_p = self._vn(m_cn, vcha_s, it)
            return [m_vn, bits_p, unan_p, done, latched, iters]

        if not (self.early_exit and self.S > 0):
            for it in range(start, self.S):
                state = step(state, vcha, it)
            return state

        widths = funnel_widths(B)
        it = start
        live = B if live is None else live
        vcha_s = vcha
        stack = []  # per shrink: (survivor idx, full-width state)
        for si in range(len(widths)):
            nxt = widths[si + 1] if si + 1 < len(widths) else 0
            while it < self.S and live > nxt:
                state = step(state, vcha_s, it, self._live)
                live = self._live.read()  # waits while the VN pass runs
                it += 1
            if nxt:
                # stable ascending sort of done: the first nxt columns hold
                # every undecided frame, padded with finished ones
                idx = torch.argsort(state[3].to(torch.uint8), stable=True)[:nxt]
                stack.append((idx, state))
                state = [s.index_select(s.dim() - 1, idx) for s in state]
                vcha_s = vcha_s.index_select(1, idx)
        for idx, full in reversed(stack):
            merged = []
            for f, s in zip(full, state):
                if any(f is b for b in borrowed):
                    f = f.clone()
                merged.append(f.index_copy_(f.dim() - 1, idx, s))
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
        with raw=True what ``raw_carry`` returns.  The caller's tensors are
        not written: done, iters and latched (which the loop updates in
        place) are copied where they would be the caller's own."""
        if not self.early_exit:
            raise ValueError("resume requires early_exit")
        if self._ph:
            raise ValueError("the continuation is not phantom-aware")
        if not 0 <= k <= self.S:
            raise ValueError(f"resume at iteration {k} outside [0, {self.S}]")
        vcha, _ = self._values(llr_cha)
        lat = latched.to(torch.int8)
        state = [m_vn.to(self.dtype).contiguous(), bits_p.to(torch.int8), unan_p,
                 done.clone(), lat.clone() if _shares(lat, latched) else lat,
                 iters.clone()]
        # the caller's own tensors: the loop replaces them at its first
        # step, a funnel merge before it copies them
        borrowed = [t for t, given in zip(state[:3], (m_vn, bits_p, unan_p))
                    if _shares(t, given)]
        state = self._loop(vcha, state, start=k, live=int((~done).sum()),
                           borrowed=borrowed)
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
            self._latch(unan_p, synd, done, iters, bits_p, latched, self.S)
        node_pos = self.ten.vn_node_pos
        if self.is_prefix:
            return latched[node_pos].T.to(torch.uint8), done, iters
        dec_bits = self._decision(m_cn, vcha)
        bits_grp = torch.where(done[None, :], latched, dec_bits)
        ok = done | self._syndrome_ok(bits_grp)
        return bits_grp[node_pos].T.to(torch.uint8), ok, iters

    # ------------------------------------------------------------------
    @staticmethod
    def _eval_dec(ops, vals):
        """Root output of a decision tree (ops from ``_tree_params``) on the
        float32 leaf values `vals` (messages, then the channel)."""
        vals = list(vals)
        for operands, thr, lev, tlo, thi in ops:
            s = vals[operands[0]]
            for sl in operands[1:]:
                s = s + vals[sl]
            o = torch.full_like(s, float(lev[0]))
            for t in range(len(thr)):
                o = torch.where(s >= float(thr[t]), float(lev[t + 1]), o)
            tie = torch.where(vals[operands[-1]] < 0, float(tlo), float(thi))
            vals.append(torch.where(s == 0, tie, o))
        return vals[-1]

    def _decision(self, m_cn, vcha):
        """Decision trees on the final c2v values as ``_cn`` gives them
        (arith_decoder.py:1414-1436): (nvar_pad, B) int8 hard bits; phantom
        nodes by the tree of their true degree over their real sockets
        (:207).  Padding nodes get bits of whatever their rows hold."""
        B = m_cn.shape[1]
        m_fin = m_cn if self.loop == "std" else m_cn[self.ten.perm_c2v]
        out = []
        for bi, blk in enumerate(self.layout.vn_blocks):
            d, n, e0 = blk.degree, blk.n_pad, blk.edge_start
            m = m_fin[e0 : e0 + n * d].reshape(d, n, B).to(torch.float32)
            cha = vcha[blk.node_start : blk.node_start + n].to(torch.float32)
            root = self._eval_dec(self._dec[bi], [m[j] for j in range(d)] + [cha])
            out.append((root < 0).to(torch.int8))
        dec_bits = torch.cat(out, dim=0)
        for p in self._ph:
            vals = [m_fin[r].to(torch.float32) for r in p["real"]]
            vals.append(vcha[p["node_row"]].to(torch.float32))
            root = self._eval_dec(self._dec[p["cls"]], vals)
            dec_bits[p["node_row"]] = (root < 0).to(torch.int8)
        return dec_bits

    def _syndrome_ok(self, bits_grp):
        """Per-frame parity of the decided bits over every real check of
        the true matrix (phantom pairs contribute nothing, :220)."""
        B = bits_grp.shape[1]
        edge_bits = bits_grp[self.ten.cn_var_pos].to(torch.int32)
        if self._ph:
            edge_bits[self._cn_rows_ph] = 0
        ok = torch.ones(B, dtype=torch.bool, device=bits_grp.device)
        pos = 0
        for bi, blk in enumerate(self.layout.cn_blocks):
            d, n = blk.degree, blk.n_pad
            s = edge_bits[pos : pos + n * d].reshape(d, n, B).sum(dim=0) & 1
            ok &= ((s == 0) | self.ten.cn_padmask[bi][:, None]).all(dim=0)
            pos += n * d
        return ok
