"""JAX-free access to the reference package's shared numpy modules.

The codec, the arithmetic spec builder, the layouts and the QC plan live in
``lut_ldpc_tpu`` and import no jax themselves, but the package's
``decoder/__init__.py`` imports the JAX decoders.  Where jax is importable
(or the JAX decoder package is already loaded) the modules are imported
normally.  Otherwise bare package objects for ``lut_ldpc_tpu`` and
``lut_ldpc_tpu.decoder`` are registered first -- their ``__path__`` set,
their ``__init__`` not run -- and the submodules are imported through them.
The route is chosen up front from ``importlib.util.find_spec`` (which also
reports None for a module blocked with ``sys.modules[name] = None``), never
by catching an ImportError.  Either route yields the same module objects for
the process, so a codec designed through the JAX package is this package's
codec too.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import types

_PKG = "lut_ldpc_tpu"


def _jax_route() -> bool:
    return (f"{_PKG}.decoder" in sys.modules
            or importlib.util.find_spec("jax") is not None)


def _register_bare(name: str, path: str) -> None:
    if name in sys.modules:
        return
    mod = types.ModuleType(name)
    mod.__path__ = [path]
    mod.__package__ = name
    sys.modules[name] = mod
    parent, _, leaf = name.rpartition(".")
    if parent:
        setattr(sys.modules[parent], leaf, mod)


def _import_shared():
    if not _jax_route():
        spec = importlib.util.find_spec(_PKG)
        if spec is None or not spec.submodule_search_locations:
            raise ImportError(f"{_PKG} (the reference package) is not importable")
        root = list(spec.submodule_search_locations)[0]
        _register_bare(_PKG, root)
        _register_bare(f"{_PKG}.decoder", os.path.join(root, "decoder"))
    names = ("decoder.codec", "decoder.arith", "decoder.layout",
             "decoder.fast_layout", "core.qc", "core.tanner", "ops.pmf")
    return [importlib.import_module(f"{_PKG}.{n}") for n in names]


codec, arith, layout, fast_layout, qc, tanner, pmf = _import_shared()

LUTCodec = codec.LUTCodec
ArithBuildError = arith.ArithBuildError
build_arith_spec = arith.build_arith_spec
build_arith_prefix_spec = arith.build_arith_prefix_spec

__all__ = ["codec", "arith", "layout", "fast_layout", "qc", "tanner", "pmf",
           "LUTCodec", "ArithBuildError", "build_arith_spec",
           "build_arith_prefix_spec"]
