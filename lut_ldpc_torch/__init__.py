"""lut_ldpc_torch: the LUT-LDPC decoders in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``lut_ldpc_tpu`` is the reference.  This package reuses its
numpy-only host modules (codec design, arithmetic spec builder, layouts,
QC plans) through ``_ref`` and re-implements the device side:

- ``device``: explicit ``torch.device`` resolution (CUDA requested on a
  machine without it raises);
- ``decoder.params``: numpy spec/layout -> device tensors;
- ``decoder.qc_kernels``: the CN and VN passes of the quasi-cyclic decode
  (CUDA kernels in ``csrc/qc_kernels.cu`` plus plain-torch twins);
- ``decoder.arith_decoder`` / ``fast_decoder`` / ``hybrid`` / ``staged``:
  the decoder classes and the ``make_decoder`` / ``make_staged_decoder``
  ladder, picking the same class as the JAX package for the same codec;
- ``bench``: the headline throughput measurement on one GPU.

No module here imports jax.
"""

__version__ = "0.1.0"
