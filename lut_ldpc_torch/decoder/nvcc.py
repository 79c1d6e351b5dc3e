"""Where the port's CUDA libraries are built, with which flags, and how.

Every kernel library is a shared object with a plain C interface, compiled
with nvcc for sm_90a into ``build/torch_kernels/`` beside the package and
loaded with ctypes.  ``--fmad=false`` and no fast-math: the float32 specs are
proven exact for separately rounded left-to-right sums only.

A library's file name carries a sha256 over everything it is built from
(``library_name``: the text of its sources and the compiler flags), so a
file that exists is never stale: a change of a source or of a flag names a
new file.  ``Build`` runs one nvcc in the background, so that several units
compile side by side.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "nvcc_path", "ptxas_entries",
           "digest", "library_name", "Build"]

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


def digest(parts) -> str:
    """sha256 hex digest over byte strings, each preceded by its length."""
    h = hashlib.sha256()
    for part in parts:
        h.update(len(part).to_bytes(8, "little"))
        h.update(part)
    return h.hexdigest()


def library_name(stem: str, sources, extra_flags=()) -> str:
    """``lib{stem}_{hash16}.so``: the hash over the text of `sources` (paths:
    the unit and every file it includes) and the compiler flags, not over
    any file's modification time."""
    parts = []
    for path in sources:
        with open(path, "rb") as f:
            parts.append(f.read())
    parts.append(" ".join([*NVCC_FLAGS, *extra_flags]).encode())
    return f"lib{stem}_{digest(parts)[:16]}.so"


class Build:
    """The library `path` compiled from `source` by one nvcc in the
    background, started here where the file is missing (or `force`).
    seconds: what the compiler took (0.0 when the file was there); report:
    its ptxas -v output.  ``wait`` returns the path, or raises if the
    compiler failed: nothing falls back to another library."""

    def __init__(self, path: str, source: str, extra_flags=(), force: bool = False,
                 nvcc=nvcc_path):
        self.path, self.source = path, source
        self.seconds, self.report = 0.0, ""
        self._thread = self._rc = None
        self._lock = threading.Lock()
        if force or not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, *extra_flags, "-I", CSRC_DIR, "-o", tmp, source],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            # a thread waits on the compiler, so that `seconds` is its own time
            self._thread = threading.Thread(target=self._finish, args=(proc, tmp),
                                            daemon=True)
            self._thread.start()

    def _finish(self, proc, tmp):
        t0 = time.perf_counter()
        _, self.report = proc.communicate()
        self.seconds = time.perf_counter() - t0
        self._rc = proc.returncode
        if self._rc == 0:
            os.replace(tmp, self.path)

    def wait(self) -> str:
        with self._lock:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            if self._rc:
                raise RuntimeError(f"nvcc failed ({self._rc}) on {self.source}:\n"
                                   f"{self.report}")
            return self.path


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
