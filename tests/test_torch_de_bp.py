"""The DE-BP engines of the port on the CPU: the host copy
(lut_ldpc_torch/design/de_bp.py) against the JAX package's DEBp, and the
batched explorer (lut_ldpc_torch/design/de_bp_gpu.py) against the JAX
DEBpTPU and the host engine.  Float32 on both explorers: Pe of a point
that has stopped is held within rtol 1e-3 above the f32 floor (1e-6),
its decision below it (ROADMAP §C12)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble as JaxEnsemble
from lut_ldpc_tpu.design.de_bp import DEBp as JaxDEBp
from lut_ldpc_tpu.design.de_bp_tpu import DEBpTPU
from lut_ldpc_torch.core.ensemble import LDPCEnsemble
from lut_ldpc_torch.design.de_bp import DEBp
from lut_ldpc_torch.design.de_bp_gpu import DEBpGPU, band_sum, band_table

torch.set_num_threads(1)

# (3,6) BP at Nb=9, maxiter 1000, Pe_max 1e-6: f64 host bisection
# (tests/test_de_bp_tpu.py)
THR_36_BP = 0.88046


def ens36(jax_side=False):
    cls = JaxEnsemble if jax_side else LDPCEnsemble
    return cls(np.array([3]), np.array([1.0]), np.array([6]), np.array([1.0]))


def run_both(sigmas, ens=None, jax_ens=None, **kw):
    port = DEBpGPU(ens or ens36(), device="cpu", **kw)
    jx = DEBpTPU(jax_ens or ens36(True), **kw)
    pmf = port.channel_pmfs(sigmas)
    out_p = [t.numpy() for t in port.evolve(pmf)]
    out_j = [np.asarray(t) for t in jx._evolve(jnp.asarray(pmf.numpy()))]
    return out_p, out_j


@pytest.mark.parametrize("trace", ["var", "chk"])
def test_host_copy_trace_equals_jax(trace):
    """The copied host engine evolves exactly as the JAX package's (numpy
    on both sides): exit code, P rows and Pe trace array_equal."""
    kw = dict(var_trace=trace == "var", chk_trace=trace == "chk")
    ours = DEBp(ens36(), Nb=7)
    theirs = JaxDEBp(ens36(True), Nb=7)
    for de in (ours, theirs):
        de.set_exit_conditions(maxiter_de=60)
    for sig in (0.80, 0.95):
        a = ours.evolve(sig, **kw)
        b = theirs.evolve(sig, **kw)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(ours.tq, theirs.tq)
    np.testing.assert_array_equal(ours.tq2, theirs.tq2)


def test_decisions_equal_jax_and_host():
    """(3,6) at Nb=9: decisions at 0.80-0.94 equal the JAX explorer's and
    the host engine's; Pe as the module docstring states."""
    sigmas = np.array([0.80, 0.84, 0.86, 0.90, 0.94])
    (ach, Pe, _), (ach_j, Pe_j, _) = run_both(sigmas, Nb=9, Pe_max=1e-6, maxiter_de=1000)
    np.testing.assert_array_equal(ach, ach_j)
    above = Pe_j >= 1e-6
    np.testing.assert_allclose(Pe[above], Pe_j[above], rtol=1e-3)
    assert (Pe[~above] < 1e-6).all()
    host = DEBp(ens36(), Nb=9)
    host.Pe_max = 1e-6
    for s, a in zip(sigmas, ach):
        code, _, _ = host.evolve(float(s))
        assert (code > 0) == bool(a), (s, code, a)


def test_pe_trajectory_equals_jax():
    """After 8 iterations, before any point converges, Pe equals JAX's
    within rtol 1e-4."""
    (ach, Pe, it), (ach_j, Pe_j, it_j) = run_both([0.84, 0.9], Nb=9, maxiter_de=8,
                                                  max_ni_de_iters=30)
    assert not ach.any() and not ach_j.any()
    np.testing.assert_allclose(Pe, Pe_j, rtol=1e-4)
    assert int(it) == int(it_j) == 8


def test_threshold_near_host_and_jax():
    """threshold(points=9, rounds=3) within 3e-3 of the pinned host value
    and at the JAX explorer's final grid point or the one beside it."""
    port = DEBpGPU(ens36(), Nb=9, Pe_max=1e-6, maxiter_de=1000, device="cpu")
    thr = port.threshold(points=9, rounds=3)
    thr_j = DEBpTPU(ens36(True), Nb=9, Pe_max=1e-6, maxiter_de=1000).threshold(
        points=9, rounds=3)
    assert abs(thr - THR_36_BP) < 3e-3, thr
    step = (port.host.thr_max - port.host.thr_min) / 8**3
    assert abs(thr - thr_j) <= step * (1 + 1e-9), (thr, thr_j)


def test_irregular_batch():
    """An irregular ensemble through the incremental-degree path decides
    as in JAX: 0.7 converges, 1.1 diverges."""
    dl, lam = np.array([2, 3, 8]), np.array([0.2857, 0.2571, 0.4572])
    dr, rho = np.array([7]), np.array([1.0])
    (ach, Pe, _), (ach_j, Pe_j, _) = run_both(
        [0.7, 1.1], LDPCEnsemble(dl, lam, dr, rho), JaxEnsemble(dl, lam, dr, rho),
        Nb=9, Pe_max=1e-6, maxiter_de=500)
    assert ach.tolist() == [True, False]
    np.testing.assert_array_equal(ach, ach_j)
    np.testing.assert_allclose(Pe[1], Pe_j[1], rtol=1e-3)


def test_band_sum_equals_dense_scatter():
    """The diagonal gather-sum equals a dense scatter of contribution
    (i, k) into bin i - k within 1e-6, and two runs are equal."""
    N, K = 64, 5
    rng = np.random.default_rng(11)
    contrib = rng.uniform(0, 1, (3, N + 1, K + 1)).astype(np.float32)
    contrib *= (np.arange(K + 1)[None, :] <= np.arange(N + 1)[:, None])
    want = np.zeros((3, N + 1), np.float64)
    for i in range(N + 1):
        for k in range(min(i, K) + 1):
            want[:, i - k] += contrib[:, i, k]
    table = torch.as_tensor(band_table(N, K))
    got = band_sum(torch.as_tensor(contrib), table).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, band_sum(torch.as_tensor(contrib), table).numpy())


def test_two_runs_equal_and_flag_read_every_k():
    """Two evolves are equal, and a read of the done flag every 7
    iterations gives the outputs of a read every iteration."""
    outs = []
    for k in (1, 7, 7):
        port = DEBpGPU(ens36(), Nb=8, Pe_max=1e-6, maxiter_de=300, device="cpu")
        port.sync_every = k
        outs.append([t.numpy() for t in port.evolve(port.channel_pmfs([0.8, 0.86, 0.95]))])
    for a, b, c in zip(*outs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        DEBpGPU(ens36())
