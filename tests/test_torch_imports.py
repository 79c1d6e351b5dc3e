"""The port imports no jax: statically, and in a process where jax cannot
be imported at all (as on a GPU machine without JAX)."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib")


def _port_files():
    root = os.path.join(REPO, "lut_ldpc_torch")
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN or m.startswith("lut_ldpc_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_decodes_with_jax_blocked():
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from lut_ldpc_torch import _ref
        from lut_ldpc_torch.decoder import HybridLUTDecoder, make_staged_decoder
        qc = _ref.qc.qc_generate_regular(3, 6, Z=16, nb=8, seed=1)
        codec = _ref.LUTCodec.design(_ref.qc.qc_expand(qc), 0.85**2,
                                     max_iters=12, Nq_Cha=16, Nq_Msg=16)
        dec = make_staged_decoder(codec, "cpu")
        sig = float(_ref.pmf.snr2sig(0.5, 2.0))
        rng = np.random.default_rng(0)
        y = 1.0 + sig * rng.standard_normal((8, codec.nvar))
        lc, lm = codec.quantize_channel(2.0 * y / sig**2)
        bits, ok, iters = dec(lc, lm)
        assert bits.shape == (8, codec.nvar) and bits.dtype == torch.uint8
        b_ref, it_ref = codec.decode_ref(lc[0], lm[0])
        assert np.array_equal(np.asarray(b_ref), bits[0].numpy())
        assert (it_ref if it_ref > 0 else codec.max_iters) == int(iters[0])
        assert sys.modules["jax"] is None
        assert "lut_ldpc_tpu.decoder.arith_decoder" not in sys.modules
        print("OK", type(dec).__name__)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
