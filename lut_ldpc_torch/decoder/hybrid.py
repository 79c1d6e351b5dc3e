"""Composed decoders: value-domain segments + label-domain table tail.

Port of lut_ldpc_tpu/decoder/hybrid.py.

``HybridLUTDecoder`` (:101): the arithmetic form of a near-threshold design
often validates only a prefix of the iteration budget; the prefix runs on
the CN/VN kernels (``ArithLUTDecoder.raw_carry``), and when any frame is
still undecided its message values are mapped back to labels
(``seam_labels``) and the table decoder continues from iteration S.  Where
the float32 spec validates a longer prefix than the int16 one, a float32
middle segment runs between the two (int16 kernels for [0, S16), float32
kernels for [S16, S32), tables after).

``MixedArithDecoder`` (:258): the full float32 spec validates, the int16
spec only a prefix; iterations [0, S16) run on int16 kernels (half the
message traffic), the values are re-embedded into the float32 spec's
iteration-S16 table, and the full float32 decoder continues and finishes
with its own decision trees.

Every JAX ``lax.cond(jnp.all(done), ...)`` is a host branch on
``done.all()`` here.  The JAX package builds the mixed forms only where a
kernel path exists (a TPU, or interpret mode); this package always has one
and decides as the TPU does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .arith import ArithBuildError, build_arith_prefix_spec, build_arith_spec
from .arith_decoder import ArithLUTDecoder, as_labels, seam_bits_unan
from .fast_decoder import FastLUTDecoder

__all__ = ["HybridLUTDecoder", "MixedArithDecoder", "seam_labels",
           "seam_values", "seam_bits_unan", "root_levels"]


def seam_labels(m_vals: torch.Tensor, table) -> torch.Tensor:
    """Values (entries of the strictly monotone `table`) -> int32 labels:
    the number of entries table[1:] that a value reaches."""
    return torch.bucketize(m_vals, table[1:].to(m_vals.dtype), right=True,
                           out_int32=True)


def seam_values(m_vals: torch.Tensor, table_from, table_to) -> torch.Tensor:
    """Exact value re-embedding between two specs: entries of `table_from`
    -> the entries of `table_to` with the same labels (a label-preserving
    monotone map; hybrid.py:234-237)."""
    lab = seam_labels(m_vals, table_from)
    return table_to.index_select(0, lab.reshape(-1)).reshape(lab.shape)


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


def _seam_tables(spec16, spec32, S16, device):
    """The two specs' value tables entering iteration S16, as tensors, or
    None where they cannot be inverted label for label."""
    t16, t32 = root_levels(spec16, S16), root_levels(spec32, S16)
    if t16 is None or t32 is None or len(t16) != len(t32):
        return None
    return (torch.as_tensor(t16, device=device),
            torch.as_tensor(t32, device=device))


class HybridLUTDecoder:
    """Full-budget early-exit decoder for codecs whose arithmetic form only
    covers a prefix.  Raises ArithBuildError when no prefix exists,
    ValueError when the table tail cannot be built (callers fall back).

    kernels: False runs the value-domain segments through the plain twins
    (comparison path).  tail_runs counts the calls that took the table
    tail, mid_runs those that took the float32 middle segment."""

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
        # mixed-precision middle segment: where f32 extends the int16
        # coverage and the seam tables are invertible
        self.mid = seam = None
        if (spec16 is not None and spec32 is not None
                and spec32.num_iters > spec16.num_iters):
            seam = _seam_tables(spec16, spec32, spec16.num_iters, self.device)
        if seam is not None:
            self.pre = ArithLUTDecoder(codec, self.device, early_exit=True,
                                       spec=spec16, kernels=kernels)
            self.mid = ArithLUTDecoder(codec, self.device, early_exit=True,
                                       spec=spec32, kernels=kernels)
            self._seam16, self._seam32 = seam
            spec = spec32  # tail tables come from the f32 spec
        else:
            # single-spec policy: int16 (half the traffic) unless f32
            # validates a longer prefix
            spec = spec16
            if spec is None or (spec32 is not None
                                and spec32.num_iters > spec.num_iters):
                spec = spec32
            self.pre = ArithLUTDecoder(codec, self.device, early_exit=True,
                                       spec=spec, kernels=kernels)
        self.fast = FastLUTDecoder(codec, self.device, early_exit=True)
        self.S = spec.num_iters  # iterations covered before the table tail
        self.tail_runs = 0
        self.mid_runs = 0

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
        if self.mid is not None and not bool(done.all()):
            self.mid_runs += 1
            v32 = seam_values(m_vals, self._seam16, self._seam32)
            del m_vals
            bits_p, unan_p = seam_bits_unan(self.mid.layout, v32)
            m_vals, done, latched, iters = self.mid.resume(
                self.pre.S, cha, v32, bits_p, unan_p, done, latched, iters,
                raw=True)
        if bool(done.all()):
            bits = latched[self.pre.ten.vn_node_pos].T
            return bits, done, iters
        self.tail_runs += 1
        lab = seam_labels(m_vals, self._levels)
        m_f = lab[self._f2a_edge].T.to(self.fast.msg_dtype)
        latched_f = latched[self._f2a_node].T
        return self.fast.tail(self.S, m_f, self.fast.cha_blocks(cha), done,
                              latched_f, iters)


class MixedArithDecoder:
    """Full-budget arithmetic decoder with an int16 front segment, for
    codecs whose full float32 spec validates but whose int16 spec covers
    only a prefix (the N=64800 codes: 43 of 50).  Raises ArithBuildError
    when the composition is unavailable (callers fall back), ValueError
    only for early_exit=False.

    kernels: False runs both segments through the plain twins.  fin_runs
    counts the calls whose float32 segment ran."""

    MIN_PREFIX = 8  # shorter int16 prefixes do not pay for the seam

    def __init__(self, codec, device, early_exit: bool = True,
                 kernels: bool = True):
        if getattr(codec.graph, "qc_phantoms", ()):
            raise ArithBuildError(
                "phantom-completed graphs: mixed-precision seam is not "
                "phantom-aware")
        if not early_exit:
            raise ValueError("mixed arith decoding requires early exit")
        self.codec = codec
        self.device = resolve_device(device)
        spec16 = build_arith_prefix_spec(codec, dtype=np.int16)
        spec32 = build_arith_spec(codec, dtype=np.float32)  # full spec
        S16 = spec16.num_iters
        if S16 >= spec32.num_iters:
            raise ArithBuildError(
                "int16 covers the full budget; use the plain decoder")
        if S16 < self.MIN_PREFIX:
            raise ArithBuildError("int16 prefix too short to pay for the "
                                  "precision seam")
        seam = _seam_tables(spec16, spec32, S16, self.device)
        if seam is None:
            raise ArithBuildError("seam value tables not invertible")
        self.pre = ArithLUTDecoder(codec, self.device, early_exit=True,
                                   spec=spec16, kernels=kernels)
        self.fin = ArithLUTDecoder(codec, self.device, early_exit=True,
                                   spec=spec32, kernels=kernels)
        self.S16 = S16
        self.S = spec32.num_iters
        self._seam16, self._seam32 = seam
        self.fin_runs = 0

    def __call__(self, llr_cha, llr_msg):
        cha = as_labels(llr_cha, self.device, self.codec.nvar)
        msg = as_labels(llr_msg, self.device, self.codec.nvar)
        m16, done, latched, iters = self.pre.raw_carry(cha, msg)
        if bool(done.all()):
            return latched[self.pre.ten.vn_node_pos].T, done, iters
        self.fin_runs += 1
        v32 = seam_values(m16, self._seam16, self._seam32)
        del m16
        bits_p, unan_p = seam_bits_unan(self.fin.layout, v32)
        return self.fin.resume(self.S16, cha, v32, bits_p, unan_p, done,
                               latched, iters)
