"""Batched float belief-propagation baselines (port of
lut_ldpc_tpu/decoder/bp.py).

The reference's BP baseline is IT++'s QLLR sum-product / min-sum decoder;
its role here is the statistical cross-check of the LUT decoders' BER
curves.  The JAX package has no Pallas kernel for it (XLA gathers and
scatters per degree group), and neither has the port: torch ops on the
device.

Layout: messages are slot-major, (E, B) with the graph's VN-major edge
order on the rows and frames on the contiguous axis, so every row gather
and scatter moves whole rows of B values.

- CN update: sum-product via the phi-function boxplus (phi(x) =
  -log tanh(x/2), self-inverse), (normalized / offset) min-sum via the
  two-min trick, or qllr: IT++'s fixed-point ``LLR_calc_unit`` boxplus
  with its quantized logexp table, as prefix / suffix chains;
- VN update: one total per node, the channel value plus the slot sum taken
  left to right ``((m0 + m1) + m2) ...`` on every device (the order of the
  JAX package's reduction on the CPU, held at variable degrees 2, 3, 9 and
  17 by tests/test_torch_bp.py), minus the own message, clipped;
- the per-iteration hard-decision syndrome check with the early-exit latch
  of bp.py:202-217: a frame's outputs are frozen at its first convergence
  (``iters = ii + 1``), and ``ok = done | syndrome(final bits)``.  Frames
  are independent, so converged frames leave the working arrays (a funnel,
  compacted once a quarter of the columns has converged) with their
  latched outputs already written: the results equal the JAX decoder's,
  which keeps computing frozen frames.

minsum, nms, oms and qllr use only exact operations (adds in a fixed
order, min, clamp, products with +-1 and with float32 constants; qllr is
int32): bits, ok and iters are equal on the CPU and on a CUDA device and
equal to the JAX decoder's.  spa goes through log and tanh, which differ
between math libraries by an ulp.

LLR convention follows the reference / IT++: positive LLR = bit 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tanner import TannerGraph
from ..device import resolve_device

__all__ = ["BPDecoder", "boxplus_phi", "make_bp_decoder"]

_PHI_CLIP_LO = 1e-7
_PHI_CLIP_HI = 30.0


def boxplus_phi(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = -log(tanh(x/2)) on clipped positive input (self-inverse)."""
    x = torch.clamp(x, _PHI_CLIP_LO, _PHI_CLIP_HI)
    return -torch.log(torch.tanh(0.5 * x))


def _chain_sum(m: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 of (n, d, B), left to right."""
    acc = m[:, 0]
    for j in range(1, m.shape[1]):
        acc = acc + m[:, j]
    return acc


class BPDecoder:
    """Batched flooding BP decoder.

    algorithm: 'spa' (sum-product), 'minsum', 'nms' (normalized min-sum,
    scale), 'oms' (offset min-sum, offset), or 'qllr' (fixed-point
    sum-product with a quantized Jacobian-logexp correction table, the
    finite-precision BP of IT++'s LLR_calc_unit; qllr_table_size=0 makes it
    a min-sum on quantized values).  Calling it with (B, nvar) float LLRs
    (numpy, or a tensor on the decoder's device) returns (bits (B, nvar)
    uint8, ok (B,) bool, iters (B,) int32) on the device.
    """

    def __init__(
        self,
        graph: TannerGraph,
        device,
        max_iters: int = 50,
        algorithm: str = "spa",
        scale: float = 0.75,
        offset: float = 0.15,
        early_exit: bool = True,
        llr_clip: float = 100.0,
        qllr_scale_res: int = 12,
        qllr_table_size: int = 300,
        qllr_spacing_res: int = 7,
        qllr_total_res: int = 28,
    ):
        if getattr(graph, "qc_phantoms", ()):
            raise ValueError("phantom-completed graphs are LUT-decoder "
                             "artifacts; BP decodes the true matrix")
        if algorithm not in ("spa", "minsum", "nms", "oms", "qllr"):
            raise ValueError(f"unknown BP algorithm {algorithm!r}")
        self.device = dev = resolve_device(device)
        self._q_table = None
        if algorithm == "qllr":
            self.q_scale = 1 << qllr_scale_res
            self.q_shift = qllr_scale_res - qllr_spacing_res
            self.q_max = (1 << (qllr_total_res - 1)) - 1
            if qllr_table_size > 0:
                i = np.arange(qllr_table_size)
                delta = float(2**self.q_shift) / self.q_scale
                self._q_table = torch.as_tensor(
                    np.floor(0.5 + self.q_scale * np.log1p(np.exp(-i * delta)))
                    .astype(np.int32), device=dev)
        self.graph = graph
        self.max_iters = int(max_iters)
        self.algorithm = algorithm
        self.scale = float(scale)
        self.offset = float(offset)
        self.early_exit = early_exit
        self.llr_clip = float(llr_clip)
        self.nvar = graph.nvar
        # float32 constants, as the JAX package's weakly typed scalars
        self._scale = torch.tensor(self.scale, dtype=torch.float32, device=dev)
        self._offset = torch.tensor(self.offset, dtype=torch.float32, device=dev)

        def ix(a):
            return torch.as_tensor(np.asarray(a, np.int64).reshape(-1), device=dev)

        g = graph
        self._edge_var = ix(g.var_llr_edge_expand())
        self._cn = [(ix(g.cn_edge_idx[int(d)]), int(d)) for d in g.cn_degrees]
        self._syn = [(ix(g.cn_var_idx[int(d)]), int(d)) for d in g.cn_degrees]
        self._vn = [(ix(g.vn_edge_idx[int(d)]), ix(g.vn_node_idx[int(d)]), int(d))
                    for d in g.vn_degrees]

    # ------------------------------------------------------------------
    def _q_logexp(self, x):
        """Quantized log(1 + exp(-x/scale)) table term (x >= 0 QLLR)."""
        if self._q_table is None:
            return torch.zeros_like(x)
        idx = x >> self.q_shift
        n = self._q_table.shape[0]
        return torch.where(idx < n, self._q_table[idx.clamp(max=n - 1).long()], 0)

    def _q_boxplus(self, a, b):
        """Fixed-point Jacobian boxplus (IT++ LLR_calc_unit semantics)."""
        mag = torch.minimum(a.abs(), b.abs())
        sgn = torch.sign(a) * torch.sign(b)
        core = sgn * mag + self._q_logexp((a + b).abs()) - self._q_logexp((a - b).abs())
        return core.clamp(-self.q_max, self.q_max)

    def _cn_update_qllr(self, m):
        """Leave-one-out boxplus via prefix / suffix chains; m (n, d, B) int32."""
        d = m.shape[1]
        big = torch.full_like(m[:, 0], self.q_max)  # boxplus identity is +inf
        prefix = [big]
        for i in range(d - 1):
            prefix.append(self._q_boxplus(prefix[-1], m[:, i]))
        suffix = [big]
        for i in range(d - 1, 0, -1):
            suffix.append(self._q_boxplus(suffix[-1], m[:, i]))
        suffix = suffix[::-1]
        return torch.stack([self._q_boxplus(prefix[i], suffix[i]) for i in range(d)], dim=1)

    def _cn_update(self, m):
        """Leave-one-out boxplus over axis 1 of m (n, d, B)."""
        if self.algorithm == "qllr":
            return self._cn_update_qllr(m)
        sgn = torch.where(m < 0, -1.0, 1.0)
        sign_out = sgn.prod(dim=1, keepdim=True) * sgn  # product of the other signs
        mag = m.abs()
        if self.algorithm == "spa":
            p = boxplus_phi(mag)
            mag_out = boxplus_phi(_chain_sum(p).unsqueeze(1) - p)
        else:
            min1, idx = mag.min(dim=1, keepdim=True)
            is_min = torch.arange(m.shape[1], device=m.device).view(1, -1, 1) == idx
            min2 = torch.where(is_min, torch.inf, mag).min(dim=1, keepdim=True).values
            mag_out = torch.where(is_min, min2, min1)
            if self.algorithm == "nms":
                mag_out = self._scale * mag_out
            elif self.algorithm == "oms":
                mag_out = torch.clamp_min(mag_out - self._offset, 0.0)
        return sign_out * mag_out

    def _cn_pass(self, msgs):
        """Variable-to-check (E, B) -> check-to-variable (E, B)."""
        B = msgs.shape[1]
        out = torch.empty_like(msgs)  # every edge lies on exactly one check
        for idx, d in self._cn:
            m = msgs.index_select(0, idx).view(-1, d, B)
            out.index_copy_(0, idx, self._cn_update(m).reshape(-1, B))
        return out

    def _vn_pass(self, msgs, llr):
        """Check-to-variable (E, B), channel (nvar, B) -> (variable-to-check
        (E, B), posterior (nvar, B))."""
        B = msgs.shape[1]
        clip = self.q_max if self.algorithm == "qllr" else self.llr_clip
        out = torch.empty_like(msgs)
        post = torch.empty_like(llr)
        for rows, nodes, d in self._vn:
            node_llr = llr.index_select(0, nodes)
            if d == 0:
                post.index_copy_(0, nodes, node_llr)
                continue
            m = msgs.index_select(0, rows).view(-1, d, B)
            total = node_llr + _chain_sum(m)
            post.index_copy_(0, nodes, total)
            out.index_copy_(0, rows, torch.clamp(total.unsqueeze(1) - m, -clip, clip)
                            .reshape(-1, B))
        return out, post

    def _syndrome_ok(self, bits):
        """bits (nvar, B) uint8 -> (B,) bool: every check satisfied."""
        ok = torch.ones(bits.shape[1], dtype=torch.bool, device=bits.device)
        for idx, d in self._syn:
            s = bits.index_select(0, idx).view(-1, d, bits.shape[1]).sum(dim=1) & 1
            ok &= (s == 0).all(dim=0)
        return ok

    # ------------------------------------------------------------------
    def __call__(self, llr):
        dev = self.device
        if isinstance(llr, torch.Tensor):
            if llr.device != dev:
                raise ValueError(f"LLRs on {llr.device}, decoder on {dev}")
        else:
            llr = torch.as_tensor(np.asarray(llr), device=dev)
        llr = llr.to(torch.float32)
        if llr.dim() != 2 or llr.shape[1] != self.nvar:
            raise ValueError(f"LLRs: shape {tuple(llr.shape)}, expected (B, {self.nvar})")
        B = llr.shape[0]
        if self.algorithm == "qllr":
            llr = torch.round(llr * float(self.q_scale)).clamp(
                -self.q_max, self.q_max).to(torch.int32)
        lt = llr.t().contiguous()  # (nvar, B)
        bits_out = torch.zeros((B, self.nvar), dtype=torch.uint8, device=dev)
        ok_out = torch.zeros(B, dtype=torch.bool, device=dev)
        iters_out = torch.full((B,), self.max_iters, dtype=torch.int32, device=dev)
        ids = torch.arange(B, device=dev)  # frame of each column
        done = torch.zeros(B, dtype=torch.bool, device=dev)  # latched, not yet dropped
        n_done = 0
        msgs = lt.index_select(0, self._edge_var)
        post = lt
        for ii in range(self.max_iters):
            msgs, post = self._vn_pass(self._cn_pass(msgs), lt)
            if not self.early_exit:
                continue
            bits = (post < 0).to(torch.uint8)
            conv = self._syndrome_ok(bits) & ~done
            sel = conv.nonzero().squeeze(1)
            if sel.numel() == 0:
                continue
            frames = ids[sel]
            bits_out[frames] = bits[:, sel].t()
            ok_out[frames] = True
            iters_out[frames] = ii + 1
            done |= conv
            n_done += sel.numel()
            if n_done == ids.numel():
                return bits_out, ok_out, iters_out
            if 4 * n_done >= ids.numel():  # drop the latched columns
                keep = (~done).nonzero().squeeze(1)
                msgs, post, lt = (a.index_select(1, keep) for a in (msgs, post, lt))
                ids = ids[keep]
                done = done[keep]
                n_done = 0
        # frames never latched: the last posteriors decide
        bits = (post < 0).to(torch.uint8)
        live = ~done
        ok = self._syndrome_ok(bits)
        bits_out[ids[live]] = bits[:, live].t()
        ok_out[ids[live]] = ok[live]
        return bits_out, ok_out, iters_out


def make_bp_decoder(graph, bp_config, device, early_exit: bool = True) -> BPDecoder:
    """BPDecoder from a BPConfig (maps the reference's INI keys; a
    qllr_total_bits > 0 selects the fixed-point QLLR decoder)."""
    alg = bp_config.algorithm
    kw = {}
    if getattr(bp_config, "qllr_total_bits", 0):
        alg = "qllr"
        kw = dict(
            qllr_scale_res=bp_config.qllr_frac_bits or 12,
            qllr_table_size=bp_config.qllr_table_size,
            qllr_spacing_res=bp_config.qllr_table_frac_bits or 7,
            qllr_total_res=bp_config.qllr_total_bits,
        )
    return BPDecoder(
        graph, device, max_iters=bp_config.max_iter, algorithm=alg,
        scale=bp_config.scale, offset=bp_config.offset,
        early_exit=early_exit, **kw,
    )
