"""Where the port's CUDA libraries are built and with which flags.

Every kernel library is a shared object with a plain C interface, compiled
with nvcc for sm_90a into ``build/torch_kernels/`` beside the package and
loaded with ctypes.  ``--fmad=false`` and no fast-math: the float32 specs are
proven exact for separately rounded left-to-right sums only.
"""

from __future__ import annotations

import os
import re
import shutil

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "nvcc_path", "ptxas_entries"]

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_ROOT, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_ROOT), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def ptxas_entries(report: str, name_re: str) -> list:
    """Per kernel of a ptxas -v report whose mangled name matches `name_re`:
    dict(groups (the pattern's groups), registers, stack, spill_stores,
    spill_loads)."""
    out, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*?" + name_re, line)
        if m:
            cur = dict(groups=m.groups())
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = None
    return out
