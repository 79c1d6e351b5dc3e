"""The port's entry points (lut_ldpc_torch/entry.py) against the JAX
package's (__graft_entry__.py) on the CPU: entry("cpu") builds the same
small (3,6) codec and labels and decodes them as JAX entry()'s function
does, and dryrun_multichip runs over an 8-slot CPU mesh, on the plain
versions of the QC passes, in a process where jax, jaxlib and
lut_ldpc_tpu cannot be imported."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from lut_ldpc_torch import entry as tentry
from lut_ldpc_torch.decoder import qc_kernels as qk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_decodes_as_jax_entry():
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    want = [np.asarray(o) for o in jax.jit(fn)(*args)]
    dec, targs = tentry.entry("cpu")
    for a, t in zip(args, targs):
        assert t.device == torch.device("cpu") and t.dtype == torch.int32
        assert np.array_equal(np.asarray(a), t.numpy())
    got = [o.numpy() for o in dec(*targs)]
    assert len(got) == len(want) == 3
    for w, o in zip(want, got):
        assert np.array_equal(w.astype(np.int64), o.astype(np.int64))
    assert got[1].any()  # some frames decode at this noise level


def test_dryrun_two_slots_in_process():
    res = tentry.dryrun_multichip(2, devices=["cpu", "cpu"])
    assert res.frames.tolist() == [8]
    assert qk.PLAIN_RUNS["cn_qc_pass"] > 0 and qk.PLAIN_RUNS["vn_qc_pass"] > 0
    assert qk.LAUNCHES["cn_qc_pass"] == qk.LAUNCHES["vn_qc_pass"] == 0


def test_dryrun_multichip_with_jax_blocked():
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["lut_ldpc_tpu"] = None
        import torch
        torch.set_num_threads(1)
        from lut_ldpc_torch.entry import dryrun_multichip, entry
        dec, args = entry("cpu")
        bits, ok, iters = dec(*args)
        assert bits.shape == (16, 128)
        res = dryrun_multichip(8, "cpu")
        assert res.frames.tolist() == [32]
        assert not [m for m in sys.modules if m.startswith("lut_ldpc_tpu.")]
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "dryrun_multichip(8): OK" in proc.stdout
    assert "'cn_qc_pass': 32" in proc.stdout
