"""Generate the port's API reference from docstrings into docs/api_torch/.

The counterpart of tools/gen_docs.py (which writes docs/api/ for the JAX
package): one markdown page per module of ``lut_ldpc_torch`` with
class/function signatures and docstrings, plus an index.  Stdlib-only.
Importing a port module touches no card, so nothing is forced here.

    python -m lut_ldpc_torch.tools.gen_docs [--out DIR]   # docs/api_torch/*.md
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import pkgutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "docs", "api_torch")

PKG = "lut_ldpc_torch"


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent: str = "") -> str:
    d = inspect.getdoc(obj)
    if not d:
        return ""
    return "\n".join(indent + ln for ln in d.splitlines())


def module_page(mod) -> str:
    lines = [f"# `{mod.__name__}`", ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    pub = getattr(mod, "__all__", None)
    members = inspect.getmembers(mod)
    for name, obj in members:
        if name.startswith("_"):
            continue
        if pub is not None and name not in pub:
            continue
        if getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isclass(obj):
            lines += [f"## class `{name}{_sig(obj)}`", ""]
            if _doc(obj):
                lines += [_doc(obj), ""]
            for mname, meth in inspect.getmembers(obj):
                if mname.startswith("_") or not (
                    inspect.isfunction(meth) or isinstance(
                        meth, (property, classmethod, staticmethod))
                ):
                    continue
                f = meth.fget if isinstance(meth, property) else meth
                f = getattr(f, "__func__", f)
                if not callable(f):
                    continue
                kind = "property " if isinstance(meth, property) else ""
                lines += [f"### {kind}`{name}.{mname}{_sig(f)}`", ""]
                if _doc(f):
                    lines += [_doc(f), ""]
        elif inspect.isfunction(obj):
            lines += [f"## `{name}{_sig(obj)}`", ""]
            if _doc(obj):
                lines += [_doc(obj), ""]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="output folder (default docs/api_torch)")
    out = ap.parse_args(argv).out or OUT
    os.makedirs(out, exist_ok=True)
    pkg = importlib.import_module(PKG)
    names = [PKG]
    for m in pkgutil.walk_packages(pkg.__path__, prefix=PKG + "."):
        names.append(m.name)
    index = ["# lut_ldpc_torch API reference", "",
             "Generated by `python -m lut_ldpc_torch.tools.gen_docs` from module "
             "docstrings (the reference's `make doc` equivalent).", ""]
    skipped = 0
    for name in sorted(names):
        try:
            mod = importlib.import_module(name)
        except Exception as e:  # a module that does not import is reported, not fatal
            print(f"SKIP {name}: {e}", file=sys.stderr)
            skipped += 1
            continue
        fn = name.replace(".", "_") + ".md"
        with open(os.path.join(out, fn), "w") as f:
            f.write(module_page(mod))
        first = (inspect.cleandoc(mod.__doc__).splitlines()[0]
                 if mod.__doc__ else "")
        index.append(f"- [`{name}`]({fn}) — {first}")
    with open(os.path.join(out, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print(f"wrote {len(names) - skipped} module pages to {out}, skipped {skipped}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
