"""The port's counterparts of the repo's root tools (tools/), one module each
under the same name, run as ``python -m lut_ldpc_torch.tools.<name>``:

- ``perf_regress``: the port's per-kernel and end-to-end regression ledger
  on one CUDA device (docs/perf/kernels_torch.json);
- ``gen_docs``: the port's API reference (docs/api_torch/).
"""
