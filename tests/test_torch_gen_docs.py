"""The port's API reference generator (lut_ldpc_torch/tools/gen_docs.py)
against the JAX package's (tools/gen_docs.py, loaded from its path).

In a process where jax, jaxlib and lut_ldpc_tpu cannot be imported it
writes a page for every module of lut_ldpc_torch and an index of them all,
skipping none; every page equals the JAX tool's ``module_page`` of the same
module (text, tolerance zero).  The static import check of
tests/test_torch_imports.py reaches the new tools folder.
"""

import importlib
import importlib.util
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest

import lut_ldpc_torch
from lut_ldpc_torch.tools import gen_docs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_imports import _port_files  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return ["lut_ldpc_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(lut_ldpc_torch.__path__,
                                              prefix="lut_ldpc_torch."))


def test_writes_every_module_with_jax_blocked(tmp_path):
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["lut_ldpc_tpu"] = None
        from lut_ldpc_torch.tools import gen_docs
        assert gen_docs.main(["--out", sys.argv[1]]) == 0
        assert sys.modules["jax"] is None
        assert not [m for m in sys.modules if m.startswith("lut_ldpc_tpu.")]
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "OK"
    assert "SKIP" not in proc.stderr
    names = _port_modules()
    assert "lut_ldpc_torch.tools.perf_regress" in names and len(names) > 70
    pages = {n.replace(".", "_") + ".md" for n in names}
    assert set(os.listdir(tmp_path)) == pages | {"index.md"}
    index = (tmp_path / "index.md").read_text()
    assert index.startswith("# lut_ldpc_torch API reference\n")
    assert [ln.split("`")[1] for ln in index.splitlines() if ln.startswith("- [")] == names
    page = (tmp_path / "lut_ldpc_torch_tools_perf_regress.md").read_text()
    assert "## `check(" in page and "## `record(" in page


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_docs", os.path.join(REPO, "tools", "gen_docs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_module_pages_equal_the_jax_tool(jax_tool):
    assert (gen_docs.PKG, jax_tool.PKG) == ("lut_ldpc_torch", "lut_ldpc_tpu")
    assert os.path.relpath(gen_docs.OUT, REPO) == os.path.join("docs", "api_torch")
    for name in _port_modules():
        mod = importlib.import_module(name)
        assert gen_docs.module_page(mod) == jax_tool.module_page(mod), name


def test_import_check_reaches_the_tools_folder():
    tools = {os.path.relpath(p, REPO) for p in _port_files()
             if os.path.dirname(p) == os.path.join(REPO, "lut_ldpc_torch", "tools")}
    assert tools == {os.path.join("lut_ldpc_torch", "tools", n)
                     for n in ("__init__.py", "perf_regress.py", "gen_docs.py")}
