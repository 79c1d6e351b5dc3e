"""Monte-Carlo BER/FER simulation harness (port of
lut_ldpc_tpu/sim/ber_sim.py: its split step on one device, and its run over
a data-parallel mesh).

A batch of frames a step, every part of it on the device: codewords and
AWGN noise are drawn there, the channel LLRs are quantized to labels there
(``torch.searchsorted`` over the codec's float32 boundaries, the JAX
simulator's ``jnp.searchsorted(..., side="left")``), the decoder runs on
its kernels, and the seven counters are reduced there and read once a
batch.

Semantics kept from the JAX package (and the reference before it):
- per-SNR frame budget Nframes, early stop at Nfers frame errors (at batch
  granularity), skip-remaining-SNRs below ber_min/fer_min with explicit
  zero-padded points;
- counters: data-bit errors over the k systematic bits, frame errors per
  k-block, uncoded slicer errors over all N coded bits;
- checkpoints every ``checkpoint_every`` batches and at each SNR point,
  with an exact resume.

Random streams: the batch with global index bb at SNR index ss draws from
a fresh ``torch.Generator`` seeded by a 63-bit hash of (seed + offset, ss,
bb) (``batch_seed``), where the JAX package folds the same triple into a
threefry key.  Counters depend on nothing but that triple, so a resumed run
equals an uninterrupted one.  torch's streams are not threefry's, and the
CPU and a CUDA device draw different streams for one seed: runs agree
with the JAX package's and with each other statistically.  The
``channel=`` hook replaces the draw, so a test can feed exactly the JAX
stream.

Over a mesh (``mesh=``, lut_ldpc_torch/parallel) the run advances the
global batch index one group of len(mesh) batches at a time: slot i runs
batch bb + i with that batch's generator, and the host counts the group's
batches in global order and stops exactly where a single-device run stops
(batches of the group past a stop point are computed but never counted).
Counters and checkpoints therefore do not depend on the mesh size, and a
run resumed from a checkpoint taken in the middle of a group is exact.
As the JAX simulator does under a mesh, every slot's device decodes with
``make_decoder`` and not the staged decoder; the two decode bit-identically.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..core.alist import read_alist
from ..core.tanner import TannerGraph
from ..decoder.bp import BPDecoder, make_bp_decoder
from ..decoder.codec import LUTCodec
from ..decoder.fast_decoder import make_decoder
from ..device import resolve_device
from ..ops.pmf import snr2sig
from .channel import bpsk_awgn_llr
from .config import BERSimConfig
from .results import BERSimResults, git_version

__all__ = ["BERSim", "batch_seed", "run_from_config"]


def batch_seed(seed: int, ss: int, bb: int) -> int:
    """63-bit seed of the generator of global batch bb at SNR index ss."""
    state = np.random.SeedSequence([seed % 2**64, ss, bb]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


class _Lane:
    """The quantizer's and encoder's tensors on one device."""

    def __init__(self, sim, dev):
        codec = sim.codec
        if sim.gen_T is not None and not sim.zero_codeword:
            # 0/1 operands in float32: every partial sum is an integer below
            # 2^24, so the product is exact (CUDA has no integer matmul)
            self.gen_T = torch.as_tensor(np.asarray(sim.gen_T, np.float32), device=dev)
        if codec is not None:
            # the JAX simulator's quantizer: float32 boundaries, side "left"
            self.qb_cha = torch.as_tensor(np.asarray(codec.qb_Cha, np.float32), device=dev)
            self.qb_msg = torch.as_tensor(np.asarray(codec.qb_Msg, np.float32), device=dev)
            self.cha2msg = torch.as_tensor(np.asarray(codec.cha2msg_map, np.int32), device=dev)


class BERSim:
    """Monte-Carlo simulator for one decoder over an SNR grid.

    Exactly one of codec (LUT decoders) and bp_decoder (a BPDecoder, or
    under a mesh a dict device -> BPDecoder with one for each of this
    process's devices).  device: where the run goes without a mesh; with
    one, None or the device of this process's first slot.  channel: None,
    or a callable (ss, bb, sigma) -> (u (B, k), llr (B, nvar), y (B,
    nvar)) that replaces the device's draw for that batch (the data bits,
    and the channel output of their codeword).  mesh: a
    parallel.DPMesh to run the batches over.
    """

    def __init__(
        self,
        config: BERSimConfig,
        graph: TannerGraph,
        device=None,
        codec: LUTCodec | None = None,
        bp_decoder: BPDecoder | dict | None = None,
        gen_T: np.ndarray | None = None,
        channel=None,
        mesh=None,
    ):
        self.config = config
        self.graph = graph
        self.codec = codec
        self.bp = bp_decoder
        self.channel = channel
        self.mesh = mesh
        if (codec is None) == (bp_decoder is None):
            raise ValueError("provide exactly one of codec / bp_decoder")
        if mesh is None:
            devices = (resolve_device(device),)
        else:
            devices = mesh.devices
            if device is not None and resolve_device(device) != devices[0]:
                raise ValueError(f"device {device} is not the mesh's first slot "
                                 f"({devices[0]})")
        self.device = devices[0]
        self.zero_codeword = config.ldpc.zero_codeword
        # systematic generator: explicit (BP sims) or the codec's
        self.gen_T = gen_T if gen_T is not None else (
            None if codec is None else codec.gen_T)
        if not self.zero_codeword:
            if self.gen_T is None:
                raise ValueError("non-zero codewords require a generator")
            self.k = graph.nvar - int(np.asarray(self.gen_T).shape[1])
        else:
            # rank assumed full for zero-codeword runs (no generator needed)
            self.k = codec.k if codec is not None else graph.nvar - graph.nchk
        self.rate = self.k / graph.nvar
        if codec is not None:
            self._use_qcha = codec.initial_message_mode == "qcha"
        self._lanes = {dev: _Lane(self, dev) for dev in devices}
        self.decoders = {dev: self._decoder(dev) for dev in devices}
        self.decoder = self.decoders[self.device]
        if mesh is not None:
            from ..parallel import make_dp_step

            self._dp_step = make_dp_step(self.slot_step, mesh)

    def _decoder(self, dev):
        codec, ldpc = self.codec, self.config.ldpc
        if codec is None:
            bps = self.bp if isinstance(self.bp, dict) else {self.bp.device: self.bp}
            bps = {resolve_device(d): b for d, b in bps.items()}
            if dev not in bps:
                raise ValueError(f"no BP decoder for {dev} (have {sorted(map(str, bps))})")
            if bps[dev].device != dev:
                raise ValueError(f"BP decoder on {bps[dev].device}, simulator on {dev}")
            return bps[dev]
        if self.mesh is None and ldpc.parity_check_iter:
            # staged decoding (host-side stage orchestration): exact, and
            # cost tracks mean iterations like the reference's per-frame
            # early exit
            from ..decoder.staged import make_staged_decoder

            return make_staged_decoder(codec, dev, early_exit=True,
                                       max_batch=self.config.sim.batch_size)
        return make_decoder(codec, dev, early_exit=ldpc.parity_check_iter)

    def _lane(self, device) -> _Lane:
        return self._lanes[self.device if device is None else torch.device(device)]

    # -- the split step: draw, quantize, decode, count ----------------------
    def encode(self, u: torch.Tensor) -> torch.Tensor:
        """(B, k) uint8 data bits -> (B, nvar) uint8 codewords (on u's
        device)."""
        B = u.shape[0]
        if self.zero_codeword:
            return torch.zeros((B, self.graph.nvar), dtype=torch.uint8, device=u.device)
        gen_T = self._lane(u.device).gen_T
        parity = (u.to(torch.float32) @ gen_T).round().to(torch.int32) & 1
        return torch.cat([u, parity.to(torch.uint8)], dim=1)

    def draw(self, seed: int, ss: int, bb: int, sigma: torch.Tensor):
        """One batch's (u, x, llr, y) on sigma's device; sigma a 0-d
        float32 tensor."""
        B, k, dev = self.config.sim.batch_size, self.k, sigma.device
        if self.channel is not None:
            u, llr, y = self.channel(ss, bb, float(sigma))
            u = torch.tensor(np.asarray(u), dtype=torch.uint8, device=dev)
            llr = torch.tensor(np.asarray(llr), dtype=torch.float32, device=dev)
            y = torch.tensor(np.asarray(y), dtype=torch.float32, device=dev)
            return u, self.encode(u), llr, y
        gen = torch.Generator(device=dev)
        gen.manual_seed(batch_seed(seed, ss, bb))
        if self.zero_codeword:
            u = torch.zeros((B, k), dtype=torch.uint8, device=dev)
        else:
            u = torch.randint(0, 2, (B, k), generator=gen, dtype=torch.uint8, device=dev)
        x = self.encode(u)
        llr, y = bpsk_awgn_llr(gen, x, sigma)
        return u, x, llr, y

    def quantize(self, llr: torch.Tensor):
        """Channel LLRs -> (channel labels, initial-message labels), int32."""
        lane = self._lane(llr.device)
        llr_cha = torch.searchsorted(lane.qb_cha, llr, out_int32=True)
        if self._use_qcha:
            return llr_cha, lane.cha2msg[llr_cha.long()]
        return llr_cha, torch.searchsorted(lane.qb_msg, llr, out_int32=True)

    def _counts(self, bits, iters, u, x, slicer) -> dict:
        """The seven counters of one batch, the four reduced ones left on
        the device."""
        B, k, nvar = self.config.sim.batch_size, self.k, self.graph.nvar
        data_err = (bits[:, :k] != u).sum(dim=1)
        return dict(frames=B, data_bits=B * k, uncoded_bits=B * nvar,
                    frame_errors=(data_err > 0).sum(), data_bit_errors=data_err.sum(),
                    uncoded_bit_errors=(slicer != x).sum(),
                    decode_iters=iters.sum(dtype=torch.int64))

    @staticmethod
    def _read(c: dict) -> dict:
        """Counters as ints, the device's read in one go."""
        names = [n for n, v in c.items() if isinstance(v, torch.Tensor)]
        c.update(zip(names, torch.stack([c[n] for n in names]).tolist()))
        return c

    def count(self, bits, iters, u, x, slicer) -> dict:
        """The seven counters of one batch (one read from the device)."""
        return self._read(self._counts(bits, iters, u, x, slicer))

    def _decode_counts(self, seed: int, ss: int, bb: int, sigma: torch.Tensor) -> dict:
        u, x, llr, y = self.draw(seed, ss, bb, sigma)
        slicer = (y < 0).to(torch.uint8)
        decoder = self.decoders[sigma.device]
        if self.codec is not None:
            bits, _, iters = decoder(*self.quantize(llr))
        else:
            bits, _, iters = decoder(llr)
        return self._counts(bits, iters, u, x, slicer)

    def step(self, seed: int, ss: int, bb: int, sigma: torch.Tensor) -> dict:
        """Global batch bb at SNR index ss on sigma's device: its seven
        counters."""
        return self._read(self._decode_counts(seed, ss, bb, sigma))

    def slot_step(self, device, seed, ss, gb, sigma):
        """A mesh slot's batch: counters left on the device until the
        group's are read together."""
        sig = torch.tensor(float(sigma), dtype=torch.float32, device=device)
        return self._decode_counts(seed, ss, gb, sig)

    # ------------------------------------------------------------------
    def run(self, seed: int | None = None, verbose: bool = True,
            checkpoint_path: str | None = None,
            checkpoint_every: int = 50) -> BERSimResults:
        """Monte-Carlo sweep.  With checkpoint_path, counter state is
        persisted every checkpoint_every batches and at each SNR point;
        a rerun resumes exactly (per-batch generators keyed by (seed, SNR
        index, batch index) make the continuation identical to an
        uninterrupted run)."""
        cfg = self.config.sim
        if seed is None:
            seed = cfg.rand_seed
        seed_eff = seed + cfg.rand_seed_offset
        snr_db = np.asarray(cfg.SNRdB, dtype=np.float64)
        results = BERSimResults(
            snr_db=snr_db,
            nvar=self.graph.nvar,
            nchk=self.graph.nchk,
            rate=self.rate,
            gitversion=git_version(),
        )
        start_ss, start_bb = 0, 0
        skip_rest = False
        if checkpoint_path and os.path.exists(checkpoint_path):
            results = BERSimResults.load(checkpoint_path)
            with open(checkpoint_path + ".state") as f:
                st = json.load(f)
            start_ss, start_bb = st["ss"], st["bb"]
            skip_rest = st.get("skip_rest", False)
            if verbose:
                print(f"resuming from SNR index {start_ss}, batch {start_bb}")

        def save_ckpt(ss, bb):
            # across processes every rank holds the same counters: rank 0
            # writes them
            if not checkpoint_path or (self.mesh is not None and self.mesh.rank != 0):
                return
            results.save(checkpoint_path.removesuffix(".npz"))
            with open(checkpoint_path + ".state", "w") as f:
                json.dump({"ss": ss, "bb": bb, "skip_rest": skip_rest}, f)

        # optional profiler capture (LUT_PROFILE_DIR=<dir> writes the
        # sweep's Chrome trace there; use a small config)
        profile_dir = os.environ.get("LUT_PROFILE_DIR")
        prof = None
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if any(d.type == "cuda" for d in self._lanes):
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()

        t0 = time.perf_counter()
        for ss, snr in enumerate(snr_db):
            if ss < start_ss:
                continue
            if skip_rest:
                continue  # zero-padded point (LDPC_BER_Sim.cpp:142-149)
            sigma = float(snr2sig(self.rate, snr))
            sigma_t = torch.tensor(sigma, dtype=torch.float32, device=self.device)
            frames = int(results.frames[ss])
            ferrs = int(results.frame_errors[ss])
            bb = start_bb if ss == start_ss else 0  # the global batch index
            while frames < cfg.Nframes and ferrs <= cfg.Nfers:
                if self.mesh is None:
                    group = [self.step(seed_eff, ss, bb, sigma_t)]
                else:  # batches bb .. bb + len(mesh) - 1, in global order
                    cv = self._dp_step(seed_eff, ss, sigma, bb)
                    group = [{kk: int(v[j]) for kk, v in cv.items()}
                             for j in range(len(self.mesh))]
                for c in group:
                    if not (frames < cfg.Nframes and ferrs <= cfg.Nfers):
                        break  # computed past the stop point: never counted
                    results.add_counts(
                        ss, c["frames"], c["data_bits"], c["uncoded_bits"],
                        c["frame_errors"], c["data_bit_errors"],
                        c["uncoded_bit_errors"], c["decode_iters"],
                    )
                    frames += c["frames"]
                    ferrs += c["frame_errors"]
                    bb += 1
                    if checkpoint_path and bb % checkpoint_every == 0:
                        save_ckpt(ss, bb)
            if verbose:
                print(
                    f"SNR = {snr:g}  frames {results.frames[ss]}  "
                    f"data BER {results.ber()[ss]:.3e}  "
                    f"uncoded BER {results.uncoded_ber()[ss]:.3e}  "
                    f"FER {results.fer()[ss]:.3e}",
                    flush=True,
                )
            ber = results.ber()[ss]
            fer = results.fer()[ss]
            if ber < cfg.ber_min or fer < cfg.fer_min:
                skip_rest = True
            save_ckpt(ss + 1, 0)
        results.runtime = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "ber_sim_trace.json"))
        return results


def run_from_config(
    config: BERSimConfig,
    device,
    codes_root: str = ".",
    seed: int | None = None,
    verbose: bool = True,
    mesh=None,
):
    """Load-design-run per the INI config (the ber_sim CLI body, the
    reference's prog/ber_sim.cpp:133-154 and LDPC_BER_Sim::load).  With a
    mesh, `device` may be None and the run goes over the mesh's slots.

    Returns (results, sim); saving is the caller's business.
    """
    codec = None
    bp = None
    gen_T = None
    if config.sim.codec_filename and os.path.exists(config.sim.codec_filename):
        codec = LUTCodec.load(config.sim.codec_filename)
        graph = codec.graph
    else:
        alist = config.ldpc.parity_filename
        if not os.path.isabs(alist):
            alist = os.path.join(codes_root, config.sim.codes_dir, alist)
        if not alist.endswith(".alist"):
            alist += ".alist"
        graph = None
        if config.ldpc.qc_detect:
            from ..core.dvbs2 import load_periodic_alist

            try:
                Zd = config.ldpc.qc_detect_Z
                graph, _, _ = load_periodic_alist(alist, Zd)
                if verbose:
                    print(f"QC structure detected (Z={Zd}): QC kernel "
                          f"path enabled for {os.path.basename(alist)}")
            except ValueError:
                pass
        if graph is None:
            H = read_alist(alist)
            graph = TannerGraph.from_dense(H)

    if config.codec_type == "LUT":
        lut = config.lut
        if codec is None:
            if lut.design_thr > 0:
                sig = lut.design_thr
            else:
                ens = graph.empirical_ensemble()
                sig = float(snr2sig(ens.rate(), lut.design_SNRdB))
            reuse = None
            if lut.reuse_lut:
                reuse = np.array([int(x) for x in lut.reuse_lut.split()], dtype=bool)
            # LUT.qbits_messages: per-iteration message resolutions
            # (LDPC_BER_Sim.cpp:398: Nq_Msg = 2^qbits_messages elementwise)
            if getattr(lut, "qbits_messages", ""):
                qb = np.array([int(x) for x in lut.qbits_messages.split()])
                if len(qb) != lut.max_iter:
                    raise ValueError(
                        "LUT.qbits_messages needs max_iter entries "
                        f"({len(qb)} given, max_iter={lut.max_iter})"
                    )
                Nq_Msg = (2 ** qb.astype(np.int64))
            else:
                Nq_Msg = 2**lut.qbits_message_uniform
            codec = LUTCodec.design(
                graph,
                sig * sig,
                max_iters=lut.max_iter,
                Nq_Cha=2**lut.qbits_channel,
                Nq_Msg=Nq_Msg,
                tree_method=(
                    "filename=" + (
                        lut.trees_filename
                        if os.path.isabs(lut.trees_filename)
                        else os.path.join(codes_root, lut.trees_dir,
                                          lut.trees_filename)
                    )
                    if lut.tree_mode in ("file", "filename")
                    else lut.tree_mode
                ),
                min_lut=lut.min_lut,
                reuse_vec=reuse,
                irregular_design_strategy=lut.irregular_design_strategy,
                build_generator=not config.ldpc.zero_codeword,
                # generator cached next to the alist, like the reference's
                # <code>.gen.it (LDPC_BER_Sim.cpp:168-189)
                generator_cache=(
                    alist.removesuffix(".alist") + ".gen.npz"
                    if codec is None and not config.ldpc.zero_codeword
                    else None
                ),
            )
            graph = codec.graph  # possibly column-permuted by the generator
            codec.initial_message_mode = lut.initial_message_mode
            if (config.sim.codec_filename and config.sim.save_codec in (-1, seed)
                    and (mesh is None or mesh.rank == 0)):
                codec.save(config.sim.codec_filename)
    else:
        if not config.ldpc.zero_codeword:
            # encoded BP sims: systematic generator, cached next to the
            # alist like the reference's <code>.gen.it; the BP decoder runs
            # on the column-permuted graph so systematic bits come first
            from ..core.gf2 import make_systematic_generator_cached

            H = graph.to_dense()
            perm, gen_T, _ = make_systematic_generator_cached(
                H, alist.removesuffix(".alist") + ".gen.npz")
            graph = TannerGraph.from_dense(H[:, perm])
        # one BP decoder for each device the run goes on
        bp = {d: make_bp_decoder(graph, config.bp, d,
                                 early_exit=config.ldpc.parity_check_iter)
              for d in ((resolve_device(device),) if mesh is None else mesh.devices)}

    sim = BERSim(config, graph, device, codec=codec, bp_decoder=bp, gen_T=gen_T, mesh=mesh)
    results = sim.run(seed=seed, verbose=verbose)
    return results, sim
