"""The port imports no jax and nothing of the JAX package: statically, and
in processes where neither can be imported at all (as on a GPU machine
that has neither), which design and decode a QC codec and a
phantom-completed one, simulate, and run the DE explorers and de_sim."""

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
        # any import of these now raises ImportError
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["lut_ldpc_tpu"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from lut_ldpc_torch.core import qc
        from lut_ldpc_torch.decoder import LUTCodec, make_staged_decoder
        from lut_ldpc_torch.ops.pmf import snr2sig
        g = qc.qc_expand(qc.qc_generate_regular(3, 6, Z=16, nb=8, seed=1))
        codec = LUTCodec.design(g, 0.85**2, max_iters=12, Nq_Cha=16, Nq_Msg=16)
        dec = make_staged_decoder(codec, "cpu")
        sig = float(snr2sig(0.5, 2.0))
        rng = np.random.default_rng(0)
        y = 1.0 + sig * rng.standard_normal((8, codec.nvar))
        lc, lm = codec.quantize_channel(2.0 * y / sig**2)
        bits, ok, iters = dec(lc, lm)
        assert bits.shape == (8, codec.nvar) and bits.dtype == torch.uint8
        b_ref, it_ref = codec.decode_ref(lc[0], lm[0])
        assert np.array_equal(np.asarray(b_ref), bits[0].numpy())
        assert (it_ref if it_ref > 0 else codec.max_iters) == int(iters[0])
        # a phantom-completed graph: the toy analog of the DVB-S2 matrix
        from lut_ldpc_torch.core.dvbs2 import periodic_qc_structure
        from lut_ldpc_torch.decoder import make_decoder
        Z, q = 16, 4
        M = Z * q
        groups = [[0, 9, 34], [3, 21, 46], [1, 6, 11, 36], [2, 7, 23, 16]]
        cols = [np.array(sorted((x + t * q) % M for x in g))
                for g in groups for t in range(Z)]
        cols += [np.array([j] if j == M - 1 else [j, j + 1]) for j in range(M)]
        st, _, _ = periodic_qc_structure(cols, len(cols), M, Z)
        codec = LUTCodec.design(qc.qc_expand(st), 0.9**2, max_iters=8,
                                Nq_Cha=16, Nq_Msg=16)
        assert len(codec.graph.phantoms) == 1
        y = 1.0 + 0.66 * rng.standard_normal((8, codec.nvar))
        lc, lm = codec.quantize_channel(2.0 * y / 0.66**2)
        for loop in ("auto", "blocks"):
            pdec = type(make_decoder(codec, "cpu"))(codec, "cpu", loop=loop)
            bits, ok, iters = pdec(lc, lm)
            for f in range(8):
                b_ref, it_ref = codec.decode_ref(lc[f], lm[f])
                assert np.array_equal(np.asarray(b_ref), bits[f].numpy())
                assert abs(it_ref) == int(iters[f]) and (it_ref > 0) == bool(ok[f])
        assert sys.modules["jax"] is None
        assert not [m for m in sys.modules if m.startswith("lut_ldpc_tpu.")]
        print("OK", type(dec).__name__)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_simulates_with_jax_blocked(tmp_path):
    """The simulator, the BP baselines and the ber_sim CLI in a process
    where jax, jaxlib and lut_ldpc_tpu cannot be imported."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["lut_ldpc_tpu"] = None
        import os
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from lut_ldpc_torch.core import qc
        from lut_ldpc_torch.core.alist import write_alist
        from lut_ldpc_torch.decoder import BPDecoder, LUTCodec
        from lut_ldpc_torch.sim import BERSim, BERSimConfig, LDPCConfig, SimConfig
        from lut_ldpc_torch.cli import ber_sim
        g = qc.qc_expand(qc.qc_generate_regular(3, 6, Z=16, nb=8, seed=1))
        codec = LUTCodec.design(g, 0.85**2, max_iters=8, Nq_Cha=16, Nq_Msg=16)
        cfg = BERSimConfig(sim=SimConfig(SNRdB=np.array([3.0]), Nframes=64,
                                         batch_size=32),
                           ldpc=LDPCConfig(zero_codeword=True))
        for kw in (dict(codec=codec), dict(bp_decoder=BPDecoder(g, "cpu", 8))):
            r = BERSim(cfg, g, "cpu", **kw).run(seed=0, verbose=False)
            assert r.frames.tolist() == [64] and r.ber()[0] < r.uncoded_ber()[0]
        root = sys.argv[1]
        os.makedirs(os.path.join(root, "codes"))
        write_alist(os.path.join(root, "codes", "c.alist"), g.to_dense())
        ini = os.path.join(root, "bp.ini")
        with open(ini, "w") as f:
            f.write("[Sim]\\nSNRdB = 3\\nNframes = 8\\nbatch_size = 8\\n"
                    "[LDPC]\\nparity_filename = c\\nzero_codeword = 0\\n"
                    "[BP]\\nmax_iter = 5\\nalgorithm = nms\\n")
        assert ber_sim.main(["-p", ini, "-b", root, "--device", "cpu"]) == 0
        assert sys.modules["jax"] is None
        assert not [m for m in sys.modules if m.startswith("lut_ldpc_tpu.")]
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "OK"


def test_designs_with_jax_blocked(tmp_path):
    """The batched DE explorers and the de_sim CLI (with its explorer
    sweep) in a process where jax, jaxlib and lut_ldpc_tpu cannot be
    imported."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["lut_ldpc_tpu"] = None
        import os
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from lut_ldpc_torch.core.ensemble import LDPCEnsemble
        from lut_ldpc_torch.design import DEBpGPU, DELutGPU
        from lut_ldpc_torch.cli import de_sim
        ens = LDPCEnsemble(np.array([3]), np.array([1.0]), np.array([6]), np.array([1.0]))
        ach, Pe = DELutGPU(ens, maxiter_de=40, max_ni_de_iters=30,
                           device="cpu").evolve_batch([0.7, 1.0])
        assert ach.tolist() == [True, False] and Pe.shape == (2,)
        ach, Pe = DEBpGPU(ens, Nb=6, maxiter_de=100, device="cpu").evolve_batch([0.7, 1.0])
        assert ach.tolist() == [True, False]
        root = sys.argv[1]
        ini = os.path.join(root, "de.ini")
        with open(ini, "w") as f:
            f.write("[Sim]\\nensemble_filename = ensembles/rate0.50_dv03_dc06.ens\\n"
                    "thr_prec = 1e-2\\nmaxiter_de = 20\\naccelerator_sweep = 1\\n"
                    f"results_name = {root}/report.txt\\n"
                    "[LUT]\\nqbits = 4 4\\nmin_lut = true\\n")
        assert de_sim.main(["-p", ini, "--device", "cpu"]) == 0
        with open(os.path.join(root, "report.txt")) as f:
            assert "Threshold(s) found" in f.read()
        assert sys.modules["jax"] is None
        assert not [m for m in sys.modules if m.startswith("lut_ldpc_tpu.")]
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "OK"
