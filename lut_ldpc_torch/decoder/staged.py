"""Staged decoding and ``make_staged_decoder``, the early-exit decoder a
caller should use (port of lut_ldpc_tpu/decoder/staged.py).

``StagedLUTDecoder`` (:36): arithmetic prefix decoders at geometrically
growing iteration budgets, then the full decoder for the frames still
undecided; converged frames keep their latched outputs and only survivors
are decoded again, from scratch with the longer budget.  Decoding is
deterministic in its inputs and the early-exit latch freezes a frame's
output at first convergence, so staging is bit-identical to the full
decoder.  Survivor selection stays on the device; only each stage's
``done`` mask is read by the host.

``make_staged_decoder`` keeps the JAX package's choice (:244-287): the
``make_decoder`` result when it is a full arithmetic, mixed or hybrid
decoder whose whole batch fits the memory budget, the same decoder behind
a ``ChunkedDecoder`` when only a part of the batch fits, and a
``StagedLUTDecoder`` otherwise (prefix-only codecs whose stragglers need
a table decoder).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from .arith import ArithBuildError, build_arith_prefix_spec, build_arith_spec
from .arith_decoder import ArithLUTDecoder, as_labels
from .fast_decoder import FastLUTDecoder, make_decoder
from .hybrid import HybridLUTDecoder, MixedArithDecoder
from .lut_decoder import LUTDecoder

__all__ = ["StagedLUTDecoder", "ChunkedDecoder", "make_staged_decoder"]


def _pad_size(n: int, minimum: int = 32) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


class StagedLUTDecoder:
    """Drop-in decoder with host-side stage orchestration."""

    def __init__(self, codec, device, early_exit: bool = True,
                 first_stage_iters: int = 8, adapt: bool = True):
        if not early_exit:
            raise ValueError("staged decoding requires early exit")
        self.codec = codec
        self.device = resolve_device(device)
        self.adapt = adapt
        # prefer int16 values (half the message traffic); float32 when the
        # integer representation does not validate or covers a much shorter
        # prefix
        prefix_spec = None
        try:
            prefix_spec = build_arith_prefix_spec(codec, dtype=np.int16)
            self._dtype = np.int16
        except ArithBuildError:
            pass
        if prefix_spec is None or prefix_spec.num_iters < min(8, codec.max_iters - 1):
            spec32 = build_arith_prefix_spec(codec, dtype=np.float32)
            if prefix_spec is None or spec32.num_iters > prefix_spec.num_iters:
                prefix_spec = spec32
                self._dtype = np.float32
        self._max_prefix = s = prefix_spec.num_iters
        stage_lengths = []
        n = min(first_stage_iters, s)
        while n < s:
            stage_lengths.append(n)
            n *= 4
        stage_lengths.append(s)
        self._stage_cache = {s: self._arith(prefix_spec)}
        self.stage_iters = stage_lengths
        # the full decoder for frames not converged within the prefix
        self.full = None
        for dt in (self._dtype, np.float32):
            try:
                self.full = self._arith(build_arith_spec(codec, dtype=dt))
                break
            except ArithBuildError:
                pass
        if self.full is None:
            try:
                self.full = FastLUTDecoder(codec, self.device, early_exit=True)
            except ValueError:
                # phantom-completed graphs, non-uniform resolutions
                self.full = LUTDecoder(codec, self.device, early_exit=True)
        self._iters_seen: list = []  # per-frame iteration counts observed
        # per-call batch caps on big graphs, by the JAX package's formulas:
        # the arithmetic stages count E * max_deg int16 values a frame
        # against 1 GiB, the table-decoder fallback its (d, n_d, d)
        # leave-one-out intermediates against 512 MiB
        g = codec.graph
        max_deg = int(g.dv_vec.max())
        self._max_pad = max(32, (1 << 30) // (g.num_edges * max_deg * 2))
        loo_cost = sum(int((g.dv_vec == d).sum()) * int(d) * int(d) * 8
                       for d in g.vn_degrees)
        self._max_pad_full = max(16, min(self._max_pad, (1 << 29) // loo_cost))

    def _arith(self, spec) -> ArithLUTDecoder:
        return ArithLUTDecoder(self.codec, self.device, early_exit=True,
                               spec=spec)

    def _stage(self, n: int) -> ArithLUTDecoder:
        if n not in self._stage_cache:
            self._stage_cache[n] = self._arith(build_arith_prefix_spec(
                self.codec, max_prefix=n, dtype=self._dtype))
        return self._stage_cache[n]

    @property
    def stages(self):
        return [self._stage(n) for n in self.stage_iters]

    def _adapt_plan(self, iters: np.ndarray, done: np.ndarray):
        """Re-plan the stage lengths from the observed iteration counts: the
        smallest prefix covering about 99.5 % of the frames seen, rounded up
        to a multiple of 4 (staged.py:127)."""
        if not self.adapt:
            return
        self._iters_seen.append(iters[done])
        seen = np.concatenate(self._iters_seen)
        if len(seen) < 64:
            return
        if len(self._iters_seen) > 64:  # bound memory, keep recent history
            self._iters_seen = [seen[-65536:]]
        p = float(np.percentile(seen, 99.5)) + 1
        t1 = min(self._max_prefix, int(4 * np.ceil(p / 4)))
        plan = [t1]
        if t1 < self._max_prefix:
            plan.append(self._max_prefix)
        if plan != self.stage_iters:
            self.stage_iters = plan

    # ------------------------------------------------------------------
    def __call__(self, llr_cha, llr_msg):
        dev = self.device
        cur_cha = as_labels(llr_cha, dev, self.codec.nvar)
        cur_msg = as_labels(llr_msg, dev, self.codec.nvar)
        B, nvar = cur_cha.shape
        if B > self._max_pad:  # bound per-call device memory
            outs = [self(cur_cha[lo : lo + self._max_pad],
                         cur_msg[lo : lo + self._max_pad])
                    for lo in range(0, B, self._max_pad)]
            return tuple(torch.cat(parts) for parts in zip(*outs))
        bits = torch.zeros((B, nvar), dtype=torch.uint8, device=dev)
        ok = torch.zeros(B, dtype=torch.bool, device=dev)
        iters = torch.full((B,), self.codec.max_iters, dtype=torch.int32, device=dev)
        remaining = np.arange(B)  # absolute frame ids of cur_* rows [:len]
        idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)

        def scatter(out, rel_sel, abs_idx):
            sel, tgt = idx(rel_sel), idx(abs_idx)
            for full, part in zip((bits, ok, iters), out):
                full[tgt] = part[sel]

        for stage in self.stages:
            out = stage(cur_cha, cur_msg)
            done_np = out[1].cpu().numpy()[: len(remaining)]
            rel_conv = np.nonzero(done_np)[0]
            if rel_conv.size:
                scatter(out, rel_conv, remaining[rel_conv])
            rel_left = np.nonzero(~done_np)[0]
            remaining = remaining[~done_np]
            if len(remaining) == 0:
                break
            # wrap-pad the survivors to the next power of two
            idxp = idx(np.resize(rel_left, _pad_size(len(remaining))))
            cur_cha, cur_msg = cur_cha[idxp], cur_msg[idxp]

        # the full decode, chunked to the big-graph batch cap
        n = len(remaining)
        for lo in range(0, n, self._max_pad_full):
            hi = min(lo + self._max_pad_full, n)
            idxp = idx(np.resize(np.arange(lo, hi), _pad_size(hi - lo)))
            scatter(self.full(cur_cha[idxp], cur_msg[idxp]),
                    np.arange(hi - lo), remaining[lo:hi])
        self._adapt_plan(iters.cpu().numpy(), ok.cpu().numpy())
        return bits, ok, iters


class ChunkedDecoder:
    """Split oversized batches into budget-sized chunks and run the inner
    decoder per chunk (staged.py:214).  Frames are independent and the
    inner decoder is deterministic, so outputs are bit-identical to one
    full-batch call.  The short final chunk runs at its own width: eager
    kernels take any batch width, so it needs none of the JAX package's
    padding to a compiled shape."""

    def __init__(self, inner, chunk: int):
        if chunk < 1:
            raise ValueError("chunk must be positive")
        self.inner = inner
        self.chunk = int(chunk)

    def __call__(self, llr_cha, llr_msg):
        B = llr_cha.shape[0]
        if B <= self.chunk:
            return self.inner(llr_cha, llr_msg)
        outs = [self.inner(llr_cha[lo : lo + self.chunk],
                           llr_msg[lo : lo + self.chunk])
                for lo in range(0, B, self.chunk)]
        return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def make_staged_decoder(codec, device, early_exit: bool = True,
                        max_batch: int = 4096):
    """Best early-exit decoder for the codec.  max_batch: the largest
    per-call batch the caller will use; LUT_DECODE_MEM_BUDGET (bytes)
    overrides the memory budget the JAX package chunks by."""
    if not early_exit:
        return make_decoder(codec, device, early_exit=False)
    dec = make_decoder(codec, device, early_exit=True)
    g = codec.graph
    budget = int(os.environ.get("LUT_DECODE_MEM_BUDGET", 1 << 30))
    fit = budget // (g.num_edges * int(g.dv_vec.max()) * 2)
    full_arith = isinstance(dec, ArithLUTDecoder) and not dec.is_prefix
    if full_arith or isinstance(dec, (HybridLUTDecoder, MixedArithDecoder)):
        if fit >= max_batch:
            return dec
        if fit >= 32:
            chunk = 32
            while chunk * 2 <= fit:
                chunk *= 2
            return ChunkedDecoder(dec, chunk)
    try:
        return StagedLUTDecoder(codec, device, early_exit=True)
    except ArithBuildError:
        return dec
