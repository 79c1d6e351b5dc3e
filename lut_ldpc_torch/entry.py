"""Entry points of the port: a single-device decode and a data-parallel dry
run (counterpart of the repo root's __graft_entry__.py, which is the JAX
package's).

entry(device) returns the decoder of a small (3,6) codec and example
labels on that device.  dryrun_multichip(n, device) runs one Monte-Carlo
run (zero codeword -> BPSK/AWGN -> channel quantization -> LUT decode ->
counters) of a quasi-cyclic codec over an n-slot mesh, and checks that the
QC kernel path decoded before it prints OK.

    python -m lut_ldpc_torch.entry cuda 2      # two slots on the first card
    python -m lut_ldpc_torch.entry cpu 8
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["entry", "dryrun_multichip"]


def _small_codec(nvar=128, dv=3, dc=6, max_iters=5, seed=3):
    """The (3,6) codec of __graft_entry__._small_codec: the same
    configuration-model graph from the same seed, designed at 2 dB."""
    from .core.tanner import TannerGraph
    from .decoder import LUTCodec
    from .ops.pmf import snr2sig

    rng = np.random.default_rng(seed)
    nchk = nvar * dv // dc
    var_sockets = np.repeat(np.arange(nvar), dv)
    chk_sockets = np.repeat(np.arange(nchk), dc)
    for _ in range(2000):
        perm = rng.permutation(len(var_sockets))
        pairs = set(zip(var_sockets.tolist(), chk_sockets[perm].tolist()))
        if len(pairs) == len(var_sockets):
            break
    H = np.zeros((nchk, nvar), dtype=np.uint8)
    for v, c in pairs:
        H[c, v] = 1
    graph = TannerGraph.from_dense(H)
    sig = float(snr2sig(0.5, 2.0))
    return LUTCodec.design(graph, sig * sig, max_iters=max_iters, Nq_Cha=16, Nq_Msg=16)


def entry(device):
    """(decoder, (llr_cha, llr_msg)): make_decoder's decoder of a small
    (3,6) codec on `device` and 16 frames of int32 labels there; calling
    the decoder on them returns (bits, ok, iters)."""
    import torch

    from .decoder import make_decoder
    from .device import resolve_device

    dev = resolve_device(device)
    codec = _small_codec()
    dec = make_decoder(codec, dev, early_exit=True)
    B = 16
    rng = np.random.default_rng(0)
    sig = 0.9
    y = 1.0 + sig * rng.standard_normal((B, codec.nvar))
    llr_cha, llr_msg = codec.quantize_channel(2.0 * y / sig**2)
    return dec, (torch.as_tensor(np.asarray(llr_cha, np.int32), device=dev),
                 torch.as_tensor(np.asarray(llr_msg, np.int32), device=dev))


def dryrun_multichip(n_devices: int, device="cuda", devices=None):
    """One Monte-Carlo run over an n_devices-slot mesh on tiny shapes: a QC
    codec (Z=16, nb=6, 4 iterations), 4 frames a slot.  devices: the
    slots, explicitly (e.g. ["cuda:0"] * 2 on a host with one card);
    otherwise n_devices slots of `device`'s type.  Raises unless the QC
    passes decoded: on a card their CUDA kernels launched and no
    table-driven witness did, on the CPU their plain versions ran.
    Returns the results."""
    from .core.qc import qc_expand, qc_generate_regular
    from .decoder import LUTCodec
    from .decoder import qc_kernels as qk
    from .decoder.arith_decoder import ArithLUTDecoder
    from .ops.pmf import snr2sig
    from .parallel import dp_mesh
    from .sim import BERSim, BERSimConfig, LDPCConfig, SimConfig

    mesh = dp_mesh(devices=devices) if devices is not None else dp_mesh(n_devices, device)
    if len(mesh) != n_devices:
        raise ValueError(f"{len(mesh)} slots for a {n_devices}-slot dry run")
    graph = qc_expand(qc_generate_regular(3, 6, Z=16, nb=6, seed=2))
    sig = float(snr2sig(0.5, 2.0))
    codec = LUTCodec.design(graph, sig * sig, max_iters=4, Nq_Cha=16, Nq_Msg=16)
    cfg = BERSimConfig(
        sim=SimConfig(SNRdB=np.array([2.0]), Nframes=4 * n_devices, Nfers=10**9,
                      batch_size=4),
        ldpc=LDPCConfig(zero_codeword=True),
    )
    sim = BERSim(cfg, codec.graph, codec=codec, mesh=mesh)
    for dev, dec in sim.decoders.items():
        if not (isinstance(dec, ArithLUTDecoder) and dec.loop == "qc"):
            raise AssertionError(f"QC kernel path inactive on {dev}: "
                                 f"{type(dec).__name__} loop {getattr(dec, 'loop', None)}")
    qk.reset_launches()
    res = sim.run(seed=0, verbose=False)
    types = {d.type for d in mesh.devices}
    tab = sim.decoder.tables
    for name, per_pass in (("cn_qc_pass", len(tab.cn_runs)), ("vn_qc_pass", len(tab.vn_runs))):
        if "cuda" in types and not (qk.LAUNCHES[name] > 0 and
                                    qk.CLASS_LAUNCHES[name] == qk.LAUNCHES[name] * per_pass):
            raise AssertionError(f"{name}: {qk.LAUNCHES[name]} passes, "
                                 f"{qk.CLASS_LAUNCHES[name]} class launches")
        if "cpu" in types and qk.PLAIN_RUNS[name] == 0:
            raise AssertionError(f"{name}: the plain version never ran")
    if int(res.frames[0]) != 4 * n_devices:
        raise AssertionError(f"{int(res.frames[0])} frames, expected {4 * n_devices}")
    passes = {n: qk.LAUNCHES[n] + qk.PLAIN_RUNS[n] for n in ("cn_qc_pass", "vn_qc_pass")}
    print(f"dryrun_multichip({n_devices}): OK - {int(res.frames[0])} frames on "
          f"{[str(mesh.slots[i].device) for i in mesh.local]}, BER {res.ber()[0]:.3e}, "
          f"QC passes {passes}")
    return res


if __name__ == "__main__":
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    dec, args = entry(dev)
    out = dec(*args)
    print("entry: OK", [tuple(o.shape) for o in out])
    if dev.startswith("cuda"):
        dryrun_multichip(n, devices=[dev] * n)
    else:
        dryrun_multichip(n, dev)
