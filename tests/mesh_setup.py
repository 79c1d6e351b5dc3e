"""The port-side configuration shared by tests/test_torch_mesh.py and its
two-process worker (tests/torch_mesh_worker.py): the N=96 (3,6) graph of
the JAX mesh tests, its codec designed by the port, a simulator
configuration whose Nfers stop falls inside a group of batches, and the
(3,6) ensemble.  Imports nothing of jax."""

import numpy as np

from util_codes import random_regular_H


def small_codec():
    from lut_ldpc_torch.core.tanner import TannerGraph
    from lut_ldpc_torch.decoder import LUTCodec
    from lut_ldpc_torch.ops.pmf import snr2sig

    graph = TannerGraph.from_dense(random_regular_H(96, 3, 6, seed=1))
    sig = float(snr2sig(0.5, 2.0))
    return LUTCodec.design(graph, sig**2, max_iters=6, Nq_Cha=16, Nq_Msg=16)


def sim_config(snrs=(1.5, 2.5), nframes=256, nfers=20, batch=16, module=None):
    """By default both points stop on Nfers, inside a group of 2 or 8."""
    if module is None:
        from lut_ldpc_torch import sim as module
    return module.BERSimConfig(
        sim=module.SimConfig(SNRdB=np.asarray(snrs, dtype=float), Nframes=nframes,
                             Nfers=nfers, batch_size=batch),
        ldpc=module.LDPCConfig(zero_codeword=True))


def ens36():
    from lut_ldpc_torch.core.ensemble import LDPCEnsemble

    return LDPCEnsemble(np.array([3]), np.array([1.0]), np.array([6]), np.array([1.0]))
