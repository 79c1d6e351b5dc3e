"""IT++ binary file (.it, format version 3) reader/writer.

Keeps result and codec artifacts interchangeable with the reference
toolchain: files written here load in the reference's MATLAB scripts
(scripts/itload.m) and aggregate_results.m, and files produced by the
reference binaries load here.  Format (itload.m:60-230): little-endian,
magic "IT++" + version byte, then per-variable blocks of
[hdr_bytes, data_bytes, block_bytes] uint64 triple, NUL-terminated name,
NUL-terminated type string, empty description, then typed payload (vectors
carry a uint64 length, matrices two uint64 dims, column-major data).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["itsave", "itload", "ItBin"]

_MAGIC = b"IT++"
_VERSION = 3

# type string -> (numpy dtype, element bytes)
_VEC_TYPES = {
    "bvec": (np.uint8, 1),
    "svec": (np.int16, 2),
    "ivec": (np.int32, 4),
    "fvec": (np.float32, 4),
    "dvec": (np.float64, 8),
}
_MAT_TYPES = {
    "bmat": (np.uint8, 1),
    "smat": (np.int16, 2),
    "imat": (np.int32, 4),
    "fmat": (np.float32, 4),
    "dmat": (np.float64, 8),
}
_SCALAR_TYPES = {
    "bin": (np.uint8, 1),
    "int8": (np.int8, 1),
    "int16": (np.int16, 2),
    "int32": (np.int32, 4),
    "float32": (np.float32, 4),
    "float64": (np.float64, 8),
}
_VECARRAY_TYPES = {
    "bvecArray": (np.uint8, 1),
    "ivecArray": (np.int32, 4),
    "dvecArray": (np.float64, 8),
}


class ItBin:
    """Wrap a python bool/int to force the IT++ 'bin' scalar type."""

    def __init__(self, v):
        self.v = int(bool(v))


def _classify(v):
    """(type string, payload bytes maker) for a python/numpy value."""
    if isinstance(v, str):
        data = v.encode()
        return "string", struct.pack("<Q", len(data)) + data
    if isinstance(v, ItBin):
        return "bin", bytes([v.v])
    if isinstance(v, (list, tuple)):  # Array<vec> of 1-D arrays
        arrs = [np.asarray(x) for x in v]
        if any(np.issubdtype(a.dtype, np.floating) for a in arrs):
            t, dt = "dvecArray", np.float64
        else:
            t, dt = "ivecArray", np.int32
        payload = struct.pack("<Q", len(arrs))
        for a in arrs:
            a = a.astype(dt)
            payload += struct.pack("<Q", len(a)) + a.tobytes()
        return t, payload
    a = np.asarray(v)
    if a.ndim == 0:
        if np.issubdtype(a.dtype, np.floating):
            return "float64", np.float64(a).tobytes()
        return "int32", np.int32(a).tobytes()
    if np.issubdtype(a.dtype, np.floating):
        t = "dvec" if a.ndim == 1 else "dmat"
        a = a.astype(np.float64)
    elif a.dtype == np.bool_ or (
        np.issubdtype(a.dtype, np.integer) and a.size and a.min() >= 0 and a.max() <= 1
    ):
        t = "bvec" if a.ndim == 1 else "bmat"
        a = a.astype(np.uint8)
    else:
        t = "ivec" if a.ndim == 1 else "imat"
        a = a.astype(np.int32)
    if a.ndim == 1:
        return t, struct.pack("<Q", len(a)) + a.tobytes()
    rows, cols = a.shape
    return t, struct.pack("<QQ", rows, cols) + a.T.tobytes()  # column-major


def itsave(path: str, variables: dict) -> None:
    with open(path, "wb") as f:
        f.write(_MAGIC + bytes([_VERSION]))
        for name, v in variables.items():
            tname, payload = _classify(v)
            nameb = name.encode() + b"\x00"
            typeb = tname.encode() + b"\x00"
            desc = b"\x00"
            hdr_bytes = 24 + len(nameb) + len(typeb) + len(desc)
            data_bytes = len(payload)
            block_bytes = hdr_bytes + data_bytes
            f.write(struct.pack("<QQQ", hdr_bytes, data_bytes, block_bytes))
            f.write(nameb + typeb + desc)
            f.write(payload)


def _getstr(f) -> str:
    out = bytearray()
    while True:
        c = f.read(1)
        if not c or c == b"\x00":
            return out.decode()
        out += c


def itload(path: str) -> dict:
    out = {}
    with open(path, "rb") as f:
        head = f.read(5)
        if head[:4] != _MAGIC:
            raise ValueError("not an IT++ file")
        if head[4] != _VERSION:
            raise ValueError(f"unsupported IT++ file version {head[4]}")
        while True:
            pos = f.tell()
            hdr = f.read(24)
            if len(hdr) < 24:
                break
            hdr_bytes, data_bytes, block_bytes = struct.unpack("<QQQ", hdr)
            name = _getstr(f)
            tname = _getstr(f)
            f.seek(pos + hdr_bytes)
            if not tname:  # deleted entry
                f.seek(pos + block_bytes)
                continue
            if tname in _SCALAR_TYPES:
                dt, nb = _SCALAR_TYPES[tname]
                out[name] = np.frombuffer(f.read(nb), dtype=dt)[0]
            elif tname in _VEC_TYPES:
                dt, nb = _VEC_TYPES[tname]
                (size,) = struct.unpack("<Q", f.read(8))
                out[name] = np.frombuffer(f.read(size * nb), dtype=dt).copy()
            elif tname in _MAT_TYPES:
                dt, nb = _MAT_TYPES[tname]
                rows, cols = struct.unpack("<QQ", f.read(16))
                data = np.frombuffer(f.read(rows * cols * nb), dtype=dt)
                out[name] = data.reshape(cols, rows).T.copy()
            elif tname == "string":
                (size,) = struct.unpack("<Q", f.read(8))
                out[name] = f.read(size).decode()
            elif tname in _VECARRAY_TYPES:
                dt, nb = _VECARRAY_TYPES[tname]
                (count,) = struct.unpack("<Q", f.read(8))
                arrs = []
                for _ in range(count):
                    (sz,) = struct.unpack("<Q", f.read(8))
                    arrs.append(np.frombuffer(f.read(sz * nb), dtype=dt).copy())
                out[name] = arrs
            else:
                raise ValueError(f"unsupported IT++ type {tname!r} for {name!r}")
            f.seek(pos + block_bytes)
    return out
