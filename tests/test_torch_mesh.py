"""The port's data-parallel mesh (lut_ldpc_torch/parallel) and the
simulator over it, on the CPU.

Slot i of a group runs global batch bb + i with the generator a
single-device run gives that batch, and the host counts the group's
batches in order up to the stop point, so the seven counters must not
depend on the mesh: 1, 2 and 8 slots, two gloo processes and the unmeshed
run agree, also where an Nfers stop falls inside a group and after a
resume from a checkpoint taken inside one.  With the JAX stream fed
through ``channel=``, the 8-slot run equals the JAX BERSim over the
conftest's 8 virtual devices point for point.  Graph: the N=96 (3,6) code
of the JAX mesh tests (tests/test_sim.py, tests/test_multiprocess.py).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lut_ldpc_torch import sim as tsim
from lut_ldpc_torch.cli import ber_sim as tcli
from lut_ldpc_torch.core.alist import write_alist
from lut_ldpc_torch.design import DELutGPU
from lut_ldpc_torch.ops.pmf import snr2sig
from lut_ldpc_torch.parallel import (dp_mesh, dp_mesh_2d, make_dp_step, make_dp_step_2d,
                                     multihost_init)

from mesh_setup import ens36, sim_config, small_codec
from torch_carry import carry, jax_stream
from util_codes import random_regular_H

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
COUNTERS = ("frames", "data_bits", "uncoded_bits", "frame_errors",
            "data_bit_errors", "uncoded_bit_errors", "decode_iters")


@pytest.fixture(scope="module")
def codec():
    torch.set_num_threads(2)
    return small_codec()


@pytest.fixture(scope="module")
def unmeshed(codec):
    return tsim.BERSim(sim_config(), codec.graph, "cpu", codec=codec).run(seed=0, verbose=False)


def _counters(r):
    return {name: getattr(r, name).tolist() for name in COUNTERS}


@pytest.mark.parametrize("n", [1, 2, 8])
def test_counters_equal_across_slot_counts(codec, unmeshed, n):
    sim = tsim.BERSim(sim_config(), codec.graph, None, codec=codec, mesh=dp_mesh(n, "cpu"))
    got = sim.run(seed=0, verbose=False)
    assert _counters(got) == _counters(unmeshed)
    # both points stopped on Nfers, after 3 and 5 batches: inside a group
    # of 2 and of 8
    assert unmeshed.frames.tolist() == [48, 80]
    assert (unmeshed.frame_errors > 20).all()
    # a mesh decodes with make_decoder, as the JAX simulator under a mesh
    assert type(sim.decoder).__name__ == "ArithLUTDecoder"


class _Interrupted(Exception):
    pass


@pytest.mark.parametrize("n", [2, 8])
def test_resume_from_a_checkpoint_inside_a_group(tmp_path, codec, n):
    """An 8-slot run that checkpoints every 3 batches is cut while drawing
    its second group: its last checkpoint, after batch 6, lies inside the
    first group.  Resumed on n slots, the counters are the uninterrupted
    run's."""
    cfg = sim_config(nfers=10**9, nframes=320)
    plain = tsim.BERSim(cfg, codec.graph, "cpu", codec=codec)
    full = plain.run(seed=0, verbose=False)

    def draw_until_8(ss, bb, sigma):  # the port's own draw, cut at batch 8
        if bb >= 8:
            raise _Interrupted
        u, _, llr, y = plain.draw(0, ss, bb, torch.tensor(sigma, dtype=torch.float32))
        return u, llr, y

    ckpt = str(tmp_path / "ck.npz")
    with pytest.raises(_Interrupted):
        tsim.BERSim(cfg, codec.graph, None, codec=codec, mesh=dp_mesh(8, "cpu"),
                    channel=draw_until_8).run(seed=0, verbose=False, checkpoint_path=ckpt,
                                              checkpoint_every=3)
    with open(ckpt + ".state") as f:
        assert json.load(f) == {"ss": 0, "bb": 6, "skip_rest": False}
    assert tsim.BERSimResults.load(ckpt).frames.tolist() == [96, 0]
    resumed = tsim.BERSim(cfg, codec.graph, None, codec=codec, mesh=dp_mesh(n, "cpu")).run(
        seed=0, verbose=False, checkpoint_path=ckpt)
    assert _counters(resumed) == _counters(full)


def test_equals_jax_meshed_bersim_under_the_jax_stream(tmp_path):
    """The port on 8 slots, fed the JAX draws, against the JAX BERSim over
    the 8 virtual devices (its make_dp_step, fold_in(key_snr, gb) keys)."""
    import jax

    from lut_ldpc_tpu import sim as jsim
    from lut_ldpc_tpu.core.tanner import TannerGraph as JaxGraph
    from lut_ldpc_tpu.decoder import LUTCodec as JaxCodec
    from lut_ldpc_tpu.parallel import dp_mesh as jax_dp_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    sig = float(snr2sig(0.5, 2.0))
    jcodec, tcodec = carry(JaxCodec.design(
        JaxGraph.from_dense(random_regular_H(96, 3, 6, seed=1)), sig**2, max_iters=6,
        Nq_Cha=16, Nq_Msg=16), tmp_path / "c.npz")
    jcfg, tcfg = sim_config(module=jsim), sim_config()
    want = jsim.BERSim(jcfg, jcodec.graph, codec=jcodec, mesh=jax_dp_mesh(8)).run(
        seed=3, verbose=False)
    port = tsim.BERSim(tcfg, tcodec.graph, None, codec=tcodec, mesh=dp_mesh(8, "cpu"),
                       channel=jax_stream(jcfg, tcodec.k, tcodec.nvar, None, 3))
    got = port.run(seed=3, verbose=False)
    assert _counters(got) == _counters(want)
    assert 0 < got.frames[0] < 256 and got.frame_errors.sum() > 0


def test_dp_step_2d_rows_equal_1d_runs(codec):
    """Mirrors test_multiprocess.py::test_dp_mesh_2d_snr_by_batch: two SNR
    rows of four slots; row r equals a 1-D 4-slot step at SNR index r."""
    sim = tsim.BERSim(sim_config(snrs=(2.0, 3.0)), codec.graph, "cpu", codec=codec)
    mesh2d = dp_mesh_2d(2, 8, "cpu")
    assert mesh2d.shape == (2, 4)
    sigmas = [float(snr2sig(sim.rate, s)) for s in (2.0, 3.0)]
    out = make_dp_step_2d(sim.slot_step, mesh2d)(7, sigmas, 5)
    assert out["frames"].tolist() == [64, 64]
    assert out["data_bit_errors"][1] <= out["data_bit_errors"][0]
    step1d = make_dp_step(sim.slot_step, dp_mesh(4, "cpu"))
    for r in range(2):
        ref = step1d(7, r, sigmas[r], 5)
        for k in COUNTERS:
            assert int(ref[k].sum()) == int(out[k][r]), (r, k)
        # slot j of the row is the single-device batch 5 + j
        one = sim.step(7, r, 6, torch.tensor(sigmas[r], dtype=torch.float32))
        assert {k: int(v[1]) for k, v in ref.items()} == one


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_gloo_processes_equal_one_process_two_slots(tmp_path, codec):
    """Mirrors test_multiprocess.py::test_two_process_mesh_matches_single_process:
    two processes of one CPU slot each, joined by gloo, give the counters
    of one process with two slots (and of the unmeshed run), and the DE
    explorer's points gathered across them equal the unmeshed batch."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
                               str(r), "2", str(port), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert ranks[0] == ranks[1]
    two = tsim.BERSim(sim_config(), codec.graph, None, codec=codec,
                      mesh=dp_mesh(2, "cpu")).run(seed=0, verbose=False)
    for name in ("frames", "frame_errors", "data_bit_errors", "uncoded_bit_errors",
                 "decode_iters"):
        assert ranks[0][name] == getattr(two, name).tolist(), name
    ach, Pe = DELutGPU(ens36(), maxiter_de=30, max_ni_de_iters=30,
                       device="cpu").evolve_batch([0.8, 0.85, 0.9])
    assert ranks[0]["ach"] == ach.tolist()
    assert ranks[0]["Pe"] == Pe.tolist()


def test_no_mesh_shrinks_or_guesses(codec):
    """A mesh never shrinks to the devices that exist, and the slot list is
    explicit."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dp_mesh(2, "cuda")
    with pytest.raises(ValueError):
        dp_mesh(2, "cpu", devices=["cpu"])
    with pytest.raises(ValueError):
        dp_mesh(0, "cpu")
    with pytest.raises(ValueError):
        dp_mesh(devices=[])
    with pytest.raises(ValueError):
        dp_mesh_2d(3, 8, "cpu")  # 8 slots do not make 3 rows
    m = dp_mesh(devices=["cpu"] * 3)
    assert len(m) == 3 and m.devices == (torch.device("cpu"),) and m.world == 1
    assert m.gather([np.arange(2) + i for i in range(3)]).tolist() == [[0, 1], [1, 2], [2, 3]]
    with pytest.raises(ValueError):
        m.gather([np.arange(2)])
    with pytest.raises(ValueError, match="device is required"):
        tsim.BERSim(sim_config(), codec.graph, None, codec=codec)
    assert multihost_init() is False  # no launcher environment here


def test_ber_sim_cli_mesh_equals_one_device(tmp_path):
    (tmp_path / "codes").mkdir()
    write_alist(str(tmp_path / "codes" / "c96.alist"), random_regular_H(96, 3, 6, seed=1))
    ini = tmp_path / "ber.ini"
    ini.write_text("[Sim]\nSNRdB = 1.5 2.5\nNframes = 64\nNfers = 10\nbatch_size = 16\n"
                   "results_dir = results\n\n[LDPC]\nparity_filename = c96\n"
                   "zero_codeword = 1\n\n[BP]\nmax_iter = 10\nalgorithm = nms\n")
    got = {}
    for mesh in ("0", "4"):
        assert tcli.main(["-p", str(ini), "-b", str(tmp_path), "--device", "cpu",
                          "--mesh", mesh, "-c", f"_m{mesh}"]) == 0
        out = tmp_path / "results"
        (d,) = [x for x in os.listdir(out) if x.endswith(f"_m{mesh}")]
        (f,) = [x for x in os.listdir(out / d) if x.endswith(".npz")]
        got[mesh] = _counters(tsim.BERSimResults.load(str(out / d / f)))
    assert got["0"] == got["4"]
    assert got["0"]["frames"][0] < 64  # Nfers stopped point 0 inside a group of 4
