"""lut_ldpc_torch: the LUT-LDPC decoders in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``lut_ldpc_tpu`` is the reference, and this package imports
nothing of it: it keeps its own copy of the numpy host modules it needs,
under the same sub-package names, and re-implements the device side:

- ``core`` (alist, Tanner graph, QC structure, LUT trees, GF(2), ensemble),
  ``ops`` (pmf, quantizer), ``design`` (density evolution, tree templates),
  ``utils.itfile``, ``_native`` (ctypes loader of csrc/lut_core.cpp, built
  into ``build/torch_kernels/``): the host-side copies;
- ``decoder.codec`` / ``arith`` / ``layout`` / ``fast_layout``: the codec
  with its scalar golden model, the arithmetic spec construction, the layouts;
  ``decoder.codec_from_arrays`` takes a codec file saved by either package;
- ``device``: explicit ``torch.device`` resolution (CUDA requested on a
  machine without it raises);
- ``decoder.params``: numpy spec/layout -> device tensors;
- ``decoder.qc_kernels``: the CN and VN passes, for quasi-cyclic graphs and
  for graphs without circulant structure (CUDA kernels in
  ``csrc/qc_kernels.cu`` plus plain-torch twins);
- ``decoder.arith_decoder`` / ``fast_decoder`` / ``hybrid`` / ``staged``:
  the decoder classes and the ``make_decoder`` / ``make_staged_decoder``
  ladder, picking the class the JAX package picks on a TPU for the same
  codec;
- ``bench`` / ``bench_n64800`` / ``profile_decode``: throughput of the
  headline and of the N=64800 codes on one GPU, and where the time goes.

No module here imports jax or lut_ldpc_tpu.
"""

__version__ = "0.1.0"
