"""Hybrid decoder: value-domain prefix + label-domain table tail.

Port of lut_ldpc_tpu/decoder/hybrid.py ``HybridLUTDecoder`` (:101), the
single-spec branch.  The arithmetic form of a near-threshold design often
validates only a prefix of the iteration budget; the prefix runs on the QC
kernels (``ArithLUTDecoder.raw_carry``), and when any frame is still
undecided its message values are mapped back to labels (``seam_labels``)
and the table decoder continues from iteration S.  The JAX ``lax.cond``
becomes a host branch on ``done.all()``.

The mixed-precision middle segment (an f32 continuation after an int16
prefix) raises NotImplementedError where the JAX package would build it
(ROADMAP A5).
"""

from __future__ import annotations

import numpy as np
import torch

from .._ref import ArithBuildError, build_arith_prefix_spec, build_arith_spec
from ..device import resolve_device
from .arith_decoder import ArithLUTDecoder, as_labels
from .fast_decoder import FastLUTDecoder

__all__ = ["HybridLUTDecoder", "seam_labels", "root_levels",
           "mixed_arith_applies"]


def seam_labels(m_vals: torch.Tensor, table) -> torch.Tensor:
    """Values (entries of the strictly monotone `table`) -> int32 labels."""
    lab = torch.zeros(m_vals.shape, dtype=torch.int32, device=m_vals.device)
    for k in range(1, len(table)):
        lab += (m_vals >= table[k]).to(torch.int32)
    return lab


def root_levels(spec, it):
    """Value table entering iteration `it` of `spec` (output levels of an
    iteration-(it-1) root op), or None unless strictly monotone."""
    table = np.asarray(spec.var_trees[it - 1][0].ops[-1].levels)
    if not np.all(np.diff(table.astype(np.float64)) > 0):
        return None
    return table


def _prefix(codec, dtype):
    try:
        return build_arith_prefix_spec(codec, dtype=dtype)
    except ArithBuildError:
        return None


def _seam_ok(spec16, spec32, S16) -> bool:
    t16, t32 = root_levels(spec16, S16), root_levels(spec32, S16)
    return t16 is not None and t32 is not None and len(t16) == len(t32)


def _mid_applies(spec16, spec32) -> bool:
    """Where the JAX HybridLUTDecoder builds its f32 middle segment (with a
    kernel path available, as on its TPU)."""
    return (spec16 is not None and spec32 is not None
            and spec32.num_iters > spec16.num_iters
            and _seam_ok(spec16, spec32, spec16.num_iters))


def mixed_arith_applies(codec, min_prefix: int = 8) -> bool:
    """Where the JAX make_decoder would return a MixedArithDecoder
    (hybrid.py:258): int16 prefix of at least min_prefix iterations, a
    longer full f32 spec, and invertible seam tables."""
    if getattr(codec.graph, "qc_phantoms", ()):
        return False
    spec16 = _prefix(codec, np.int16)
    if spec16 is None:
        return False
    try:
        spec32 = build_arith_spec(codec, dtype=np.float32)
    except ArithBuildError:
        return False
    return (spec16.num_iters < spec32.num_iters
            and spec16.num_iters >= min_prefix
            and _seam_ok(spec16, spec32, spec16.num_iters))


class HybridLUTDecoder:
    """Full-budget early-exit decoder for codecs whose arithmetic form only
    covers a prefix.  Raises ArithBuildError when no prefix exists,
    ValueError when the table tail cannot be built (callers fall back).

    kernels: False runs the prefix through the plain twins (comparison
    path).  tail_runs counts the calls that took the table tail."""

    def __init__(self, codec, device, early_exit: bool = True,
                 kernels: bool = True):
        if getattr(codec.graph, "qc_phantoms", ()):
            raise ValueError(
                "phantom-completed graphs: hybrid tail lacks pinned-edge semantics")
        if not early_exit:
            raise ValueError("hybrid decoding requires early exit")
        self.codec = codec
        self.device = resolve_device(device)
        spec16 = _prefix(codec, np.int16)
        spec32 = _prefix(codec, np.float32)
        if spec16 is None and spec32 is None:
            raise ArithBuildError("no valid arithmetic prefix")
        if _mid_applies(spec16, spec32):
            raise NotImplementedError(
                "hybrid with an f32 middle segment after the int16 prefix: "
                "ROADMAP A5")
        # single-spec policy: int16 (half the traffic) unless f32 validates
        # a longer prefix
        spec = spec16
        if spec is None or (spec32 is not None
                            and spec32.num_iters > spec.num_iters):
            spec = spec32
        self.pre = ArithLUTDecoder(codec, self.device, early_exit=True,
                                   spec=spec, kernels=kernels)
        self.fast = FastLUTDecoder(codec, self.device, early_exit=True)
        self.S = spec.num_iters
        self.tail_runs = 0

        table = root_levels(spec, self.S)
        if table is None:
            raise ArithBuildError("iteration-S value table not strictly "
                                  "monotone; cannot invert values to labels")
        self._levels = torch.as_tensor(table, device=self.device)
        lay_a, lay_f = self.pre.layout, self.fast.layout
        inv_a = np.zeros(codec.graph.num_edges, dtype=np.int64)
        real = lay_a.vn_edge_orig >= 0
        inv_a[lay_a.vn_edge_orig[real]] = np.nonzero(real)[0]
        self._f2a_edge = torch.as_tensor(inv_a[lay_f.vn_edge_orig],
                                         device=self.device)
        self._f2a_node = torch.as_tensor(
            lay_a.vn_node_pos[lay_f.vn_nodes].astype(np.int64),
            device=self.device)

    def __call__(self, llr_cha, llr_msg):
        cha = as_labels(llr_cha, self.device, self.codec.nvar)
        msg = as_labels(llr_msg, self.device, self.codec.nvar)
        m_vals, done, latched, iters = self.pre.raw_carry(cha, msg)
        if bool(done.all()):
            bits = latched[self.pre.ten.vn_node_pos].T
            return bits, done, iters
        self.tail_runs += 1
        lab = seam_labels(m_vals, self._levels)
        m_f = lab[self._f2a_edge].T.to(self.fast.msg_dtype)
        latched_f = latched[self._f2a_node].T
        return self.fast.tail(self.S, m_f, self.fast.cha_blocks(cha), done,
                              latched_f, iters)
