"""Carry a codec designed by the JAX package across to the port.

The JAX package saves the codec; both sides then hold what that file
describes: the JAX package's own reload (``LUTCodec.load``) and the port's
``codec_from_arrays`` of the same arrays.  For a graph without QC structure
the file keeps sorted column lists, so the reloaded realization may order a
node's edges differently from the designed object: decoding the two reloads
keeps both sides on one realization.  A QC codec's file keeps its structure,
weight-2 cells and phantom completions (``qc_base2``, ``qc_phantoms``), so a
phantom-completed codec crosses with its pinned edges
(tests/test_torch_phantom.py).
"""

import numpy as np

from lut_ldpc_tpu.decoder import LUTCodec as JaxCodec

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
