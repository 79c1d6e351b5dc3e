"""The DE-LUT explorer over a mesh (DELutGPU(mesh=)) on the CPU: the JAX
mesh tests' shapes (tests/test_de_lut_tpu.py, 11 sigma points and 5 reuse
rows, both wrap-padded to 8 slots) are array_equal to the unmeshed
explorer, and decide as the JAX explorer over the conftest's 8 virtual
devices.  de_sim --mesh writes the report of a run without one."""

import numpy as np
import pytest
import torch

from lut_ldpc_torch.cli import de_sim
from lut_ldpc_torch.design import DELutGPU
from lut_ldpc_torch.parallel import dp_mesh

from torch_de_common import ens36

torch.set_num_threads(2)
KW = dict(Pe_max=1e-6, max_ni_de_iters=30)


def _jax_mesh():
    import jax

    from lut_ldpc_tpu.parallel import dp_mesh as jax_dp_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return jax_dp_mesh(8)


def test_sharded_grid_equals_unmeshed_and_jax():
    from lut_ldpc_tpu.design.de_lut_tpu import DELutTPU

    sigmas = np.linspace(0.80, 0.92, 11)  # 11 points: wrap-padded to 16
    single = DELutGPU(ens36(), maxiter_de=60, device="cpu", **KW)
    sharded = DELutGPU(ens36(), maxiter_de=60, mesh=dp_mesh(8, "cpu"), **KW)
    assert sharded.device == torch.device("cpu")
    a1, p1 = single.evolve_batch(sigmas)
    a8, p8 = sharded.evolve_batch(sigmas)
    assert np.array_equal(a1, a8)
    assert np.array_equal(p1, p8)
    assert a8.any() and not a8.all()
    a_j, _ = DELutTPU(ens36(True), maxiter_de=60, mesh=_jax_mesh(), **KW).evolve_batch(sigmas)
    assert np.array_equal(a8, a_j)


def test_sharded_reuse_equals_unmeshed_and_jax():
    """prerank_reuse at 12 iterations, where every Pe lies above the f32
    floor (tests/test_torch_de_lut.py::test_reuse_ranking_matches_jax_and_host)."""
    from lut_ldpc_tpu.design.de_lut_tpu import DELutTPU

    M = 12
    reuse = np.zeros((5, M), dtype=bool)  # 5 rows: wrap-padded to 8
    for i in range(1, 5):
        reuse[i, 2 * i] = True
    single = DELutGPU(ens36(), maxiter_de=M, device="cpu", **KW)
    sharded = DELutGPU(ens36(), maxiter_de=M, mesh=dp_mesh(8, "cpu"), **KW)
    p1, i1 = single.prerank_reuse(0.85, reuse)
    p8, i8 = sharded.prerank_reuse(0.85, reuse)
    assert np.array_equal(p1, p8)
    assert np.array_equal(i1, i8)
    assert p8.shape == (5,)
    p_j, i_j = DELutTPU(ens36(True), maxiter_de=M, mesh=_jax_mesh(), **KW).prerank_reuse(
        0.85, reuse)
    assert list(np.argsort(p8, kind="stable")) == list(np.argsort(np.asarray(p_j), kind="stable"))
    np.testing.assert_array_equal(i8, i_j)


def test_threshold_over_a_mesh_equals_unmeshed():
    single = DELutGPU(ens36(), maxiter_de=40, device="cpu", **KW)
    sharded = DELutGPU(ens36(), maxiter_de=40, mesh=dp_mesh(devices=["cpu"] * 3), **KW)
    assert sharded.threshold(points=9, rounds=2) == single.threshold(points=9, rounds=2)


def test_de_sim_mesh_writes_the_same_report(tmp_path):
    texts = []
    for mesh in ("0", "4"):
        report = tmp_path / f"m{mesh}.txt"
        ini = tmp_path / f"m{mesh}.ini"
        ini.write_text("[Sim]\nensemble_filename = ensembles/rate0.50_dv03_dc06.ens\n"
                       "thr_prec = 1e-2\nmaxiter_de = 20\naccelerator_sweep = 1\n"
                       f"results_name = {report}\n[LUT]\nqbits = 4 4\nmin_lut = true\n")
        assert de_sim.main(["-p", str(ini), "--device", "cpu", "--mesh", mesh]) == 0
        texts.append(report.read_text().replace(str(tmp_path / f"m{mesh}"), ""))
    assert texts[0] == texts[1]
    assert "Threshold(s) found" in texts[0]


def test_width_check_names_the_first_differing_op():
    """check_de_widths' trace comparison: rows of the narrow run against the
    first rows of the wide one, op by op."""
    from lut_ldpc_torch.check_de_widths import first_difference

    x = torch.arange(10.0).reshape(5, 2)
    wide = [("cumsum", [(5, 2)], [x]), ("sum", [(5, 2)], [x.sum(1)])]
    narrow = [("cumsum", [(3, 2)], [x[:3]]), ("sum", [(3, 2)], [x[:3].sum(1) + 1e-3])]
    assert first_difference(wide, narrow, 5, 3).startswith("op 1 sum")
    narrow[1] = ("sum", [(3, 2)], [x[:3].sum(1)])
    assert first_difference(wide, narrow, 5, 3) == "no traced op differs"
