"""Carry a codec designed by the JAX package across to the port.

The JAX package saves the codec; both sides then hold what that file
describes: the JAX package's own reload (``LUTCodec.load``) and the port's
``codec_from_arrays`` of the same arrays.  For a graph without QC structure
the file keeps sorted column lists, so the reloaded realization may order a
node's edges differently from the designed object: decoding the two reloads
keeps both sides on one realization.  A QC codec's file keeps its structure,
weight-2 cells and phantom completions (``qc_base2``, ``qc_phantoms``), so a
phantom-completed codec crosses with its pinned edges
(tests/test_torch_phantom.py).  ``jax_stream`` carries the JAX simulator's
random draws across the same way, through the port's ``channel=`` hook.
"""

import numpy as np

import jax
import jax.numpy as jnp

from lut_ldpc_tpu.decoder import LUTCodec as JaxCodec
from lut_ldpc_tpu.sim import channel as jchannel

from lut_ldpc_torch.decoder import codec_from_arrays


def carry(codec, path):
    """(the JAX package's reload, the port's codec) of `codec` saved at
    `path` (a file name ending in .npz)."""
    codec.save(str(path))
    with np.load(str(path), allow_pickle=False) as z:
        arrays = dict(z)
    return JaxCodec.load(str(path)), codec_from_arrays(arrays)


def labels(codec, snr_db, B, seed):
    """Channel and initial-message labels of B noisy all-zero frames."""
    from lut_ldpc_tpu.ops.pmf import snr2sig

    rng = np.random.default_rng(seed)
    sig = float(snr2sig(0.5, snr_db))
    y = 1.0 + sig * rng.standard_normal((B, codec.nvar))
    lc, lm = codec.quantize_channel(2.0 * y / sig**2)
    return np.asarray(lc, np.int32), np.asarray(lm, np.int32)


def jax_stream(cfg, k, nvar, gen_T, seed):
    """The channel hook: the JAX simulator's draw of (ss, bb), as its split
    step's gen computes it (ber_sim.py:181-197)."""
    B, zero_cw = cfg.sim.batch_size, cfg.ldpc.zero_codeword
    gT = None if gen_T is None else jnp.asarray(gen_T, jnp.int32)

    @jax.jit
    def gen(key, sigma):
        kbits, knoise = jax.random.split(key)
        if zero_cw:
            u = jnp.zeros((B, k), dtype=jnp.uint8)
            x = jnp.zeros((B, nvar), dtype=jnp.uint8)
        else:
            u = jax.random.bernoulli(kbits, 0.5, (B, k)).astype(jnp.uint8)
            parity = (jax.lax.dot_general(u.astype(jnp.int32), gT, (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32) & 1)
            x = jnp.concatenate([u, parity.astype(jnp.uint8)], axis=-1)
        llr, y = jchannel.bpsk_awgn_llr(knoise, x, sigma)
        return u, llr, y

    base = jax.random.PRNGKey(seed + cfg.sim.rand_seed_offset)

    def hook(ss, bb, sigma):
        key = jax.random.fold_in(jax.random.fold_in(base, ss), bb)
        return tuple(np.asarray(a) for a in gen(key, sigma))
    return hook
