"""The DE-LUT explorer of the port (lut_ldpc_torch/design/de_lut_gpu.py)
in its other modes on the CPU: joint_level, full-LUT CN trees and a
non-uniform message resolution (the segmented evolve), each on the JAX
test's ensemble and sigmas (tests/test_de_lut_tpu.py), against the JAX
DELutTPU and the port's host f64 DELut.  Tolerances as in
tests/test_torch_de_lut.py: rtol 1e-3 on Pe above the f32 floor, the
decision below it (ROADMAP §C12)."""

import numpy as np
import torch

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble as JaxEnsemble
from lut_ldpc_torch.core.ensemble import LDPCEnsemble
from lut_ldpc_torch.design.de import DELut, JOINT_LEVEL
from lut_ldpc_torch.design.de_lut_gpu import DELutGPU
from lut_ldpc_torch.design.templates import get_lut_tree_templates
from lut_ldpc_torch.ops.pmf import signed_to_unsigned_map
from torch_de_common import THR_36_Q4_200, assert_pe_equal, ens36, make_host, run_both

torch.set_num_threads(1)


def test_joint_level_matches_jax_and_host():
    """joint_level on the JAX test's ensemble: decisions at 0.70, 0.95 and
    1.10 equal the host's and JAX's."""
    dl, lam = np.array([2, 3, 4]), np.array([0.38354, 0.04237, 0.57409])
    dr, rho = np.array([5, 6]), np.array([0.24123, 0.75877])
    M = 60
    kw = dict(Nq_Cha=16, Nq_Msg=16, maxiter_de=M, Pe_max=1e-6, max_ni_de_iters=30,
              strategy=JOINT_LEVEL)
    sigmas = np.array([0.70, 0.95, 1.10])
    _, (ach, Pe, _), (ach_j, Pe_j, _) = run_both(
        kw, kw, sigmas, JaxEnsemble(dl, lam, dr, rho), LDPCEnsemble(dl, lam, dr, rho))
    np.testing.assert_array_equal(ach, ach_j)
    assert_pe_equal(Pe, Pe_j)
    ens = LDPCEnsemble(dl, lam, dr, rho)
    tv, tc = get_lut_tree_templates("auto_bin_balanced", ens, np.full(M, 16), 16, min_lut=True)
    host = DELut(ens, 16, np.full(M, 16), M, tv, tc, irregular_design_strategy=JOINT_LEVEL)
    host.Pe_max = 1e-6
    host.max_ni_de_iters = 30
    for s, a in zip(sigmas, ach):
        code, *_ = host.evolve(float(s))
        assert (code > 0) == bool(a), (s, code, a)


def test_full_lut_mode_matches_jax_and_host():
    """min_lut=False: CN trees with the parity/magnitude fold.  Decisions
    at 0.84, 0.87 and 0.90 equal the host full-LUT engine's and JAX's; the
    threshold beats min-LUT and lies within 3e-3 of 0.8692."""
    kw = dict(maxiter_de=200, Pe_max=1e-6, max_ni_de_iters=30, min_lut=False)
    sigmas = np.array([0.84, 0.87, 0.90])
    port, (ach, Pe, _), (ach_j, Pe_j, _) = run_both(kw, kw, sigmas)
    np.testing.assert_array_equal(ach, ach_j)
    assert_pe_equal(Pe, Pe_j)
    host = make_host(ens36(), min_lut=False)
    for s, a in zip(sigmas, ach):
        code, *_ = host.evolve(float(s))
        assert (code >= 0) == bool(a), (s, code, a)
    thr = port.threshold(points=9, rounds=3)
    assert thr > THR_36_Q4_200
    assert abs(thr - 0.8692) < 3e-3, thr


def test_chk_fold_equals_scatter():
    """The full-LUT CN fold as a gather-sum equals the scatter-add of the
    JAX explorer (np.add.at in index order) on random pmfs."""
    port = DELutGPU(ens36(), maxiter_de=4, min_lut=False, device="cpu")
    rng = np.random.default_rng(5)
    for Ka, Kb in ((16, 16), (8, 16)):
        pa = rng.uniform(0.01, 1, (3, Ka)).astype(np.float32)
        pb = rng.uniform(0.01, 1, (3, Kb)).astype(np.float32)
        got = port._chk_join(torch.as_tensor(pa), torch.as_tensor(pb)).numpy()
        p0 = (pb[:, :, None] * pa[:, None, :]).reshape(3, -1)
        p1 = (pb[:, ::-1][:, :, None] * pa[:, ::-1][:, None, :]).reshape(3, -1)
        prod0 = 0.5 * (p0 + p1)
        want = np.zeros((3, Ka * Kb // 2), np.float32)
        for r in range(3):
            np.add.at(want[r], signed_to_unsigned_map(np.array([Ka, Kb])), prod0[r])
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_segmented_nq_vector_matches_jax_and_host():
    """A 16 -> 8 per-iteration resolution vector (segmented evolve):
    decisions at 0.70, 0.78, 0.90 and 0.95 equal the host's with the same
    vector and JAX's."""
    M = 40
    nqv = np.array([16] * 20 + [8] * 20)
    kw = dict(Nq_Cha=16, Nq_Msg=nqv, maxiter_de=M, Pe_max=1e-6, max_ni_de_iters=30)
    sigmas = np.array([0.70, 0.78, 0.90, 0.95])
    port, (ach, Pe, _), (ach_j, Pe_j, _) = run_both(kw, kw, sigmas)
    assert not port.uniform_nq
    np.testing.assert_array_equal(ach, ach_j)
    assert_pe_equal(Pe, Pe_j)
    ens = ens36()
    tv, tc = get_lut_tree_templates("auto_bin_balanced", ens, nqv, 16, min_lut=True)
    host = DELut(ens, 16, nqv, M, tv, tc)
    host.Pe_max = 1e-6
    host.max_ni_de_iters = 30
    for s, a in zip(sigmas, ach):
        code, *_ = host.evolve(float(s))
        assert (code > 0) == bool(a), (s, code, a)
