"""The batched DE-LUT explorer of the port (lut_ldpc_torch/design/
de_lut_gpu.py) on the CPU, against the JAX DELutTPU, the port's host f64
DELut and the port's host quantizer.

Both explorers compute in float32.  After a fixed number of iterations
the port's Pe equals JAX's within rtol 1e-4.  Where a point has stopped,
its Pe above the f32 floor (1e-6, the explorers' lowest Pe_max) is held
within rtol 1e-3: a diverged point stops at its 30th strictly worse
iteration on a plateau, and which iteration that is depends on rounding.
Below the floor Pe is float32 noise, and a point can converge one
iteration apart (ROADMAP §C12), so there the decisions are held equal, not
the values."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble as JaxEnsemble
from lut_ldpc_tpu.design.de_lut_tpu import DELutTPU
from lut_ldpc_torch.core.ensemble import LDPCEnsemble
from lut_ldpc_torch.design.de_lut_gpu import BatchedQuantizer, DELutGPU
from lut_ldpc_torch.ops.quant import quant_mi_sym
from torch_de_common import THR_36_Q4_200, assert_pe_equal, ens36, make_host, run_both

torch.set_num_threads(1)

IRREGULAR = "ensembles/rate0.50_dv02-17_dc08-09_lut_q4.ens"


def sym_pmfs(rng, M, S):
    out = []
    for _ in range(S):
        half = rng.uniform(0.05, 1.0, M // 2)
        p = np.concatenate([half[::-1] * rng.uniform(0.1, 0.9, M // 2)[::-1], half])
        out.append(p / p.sum())
    return np.stack(out)


@pytest.mark.parametrize("M,K", [(64, 8), (256, 16)])
def test_quantizer_dp_equals_jax_and_host(M, K):
    """The batched DP on 12 random symmetric pmfs in generic position: the
    LLR sort, the boundaries astar and the label map Q equal the JAX
    explorer's; p_out lies within atol 2e-6 of JAX's and of the port's
    host quant_mi_sym."""
    rng = np.random.default_rng(7 + M)
    pmfs = sym_pmfs(rng, M, 12)
    batch = pmfs.astype(np.float32)
    qz = BatchedQuantizer("cpu")
    jx = DELutTPU(ens36(True), maxiter_de=4)
    p_t = torch.as_tensor(batch)
    idx = qz.sort_llr(p_t)
    ps = p_t.gather(1, idx)
    astar = qz.design(ps, K).numpy()
    astar_j = np.asarray(jax.jit(lambda p: jx._design(p, K))(jnp.asarray(ps.numpy())))
    np.testing.assert_array_equal(astar, astar_j)
    p_out, Q = (t.numpy() for t in qz.quantize_q(p_t, K))
    p_out_j, Q_j = (np.asarray(t) for t in jax.jit(lambda p: jx._quantize_q(p, K))(
        jnp.asarray(batch)))
    np.testing.assert_array_equal(Q, Q_j)
    np.testing.assert_allclose(p_out, p_out_j, rtol=0, atol=2e-6)
    for i, p in enumerate(pmfs):
        _, p_host, Q_host = quant_mi_sym(p, K)
        np.testing.assert_allclose(p_out[i], p_host, rtol=0, atol=2e-6)
        np.testing.assert_array_equal(Q[i], Q_host)


def test_apply_q_reproduces_design():
    """Re-applying a designed label map gives the designed pmf."""
    rng = np.random.default_rng(3)
    p = torch.as_tensor(sym_pmfs(rng, 64, 5).astype(np.float32))
    qz = BatchedQuantizer("cpu")
    p_out, Q = qz.quantize_q(p, 8)
    np.testing.assert_allclose(qz.apply_q(p, Q, 8).numpy(), p_out.numpy(), rtol=0, atol=2e-7)


def test_pe_trajectory_equals_jax():
    """Before any point converges the port's Pe equals JAX's within rtol
    1e-4 after 5 and 15 iterations (the whole per-iteration math)."""
    for n in (5, 15):
        kw = dict(maxiter_de=n, Pe_max=1e-6, max_ni_de_iters=30)
        _, (ach, Pe, it), (ach_j, Pe_j, it_j) = run_both(kw, kw, [0.82, 0.85, 0.9])
        assert not ach.any() and not ach_j.any()
        np.testing.assert_allclose(Pe, Pe_j, rtol=1e-4)
        np.testing.assert_array_equal(it, it_j)


def test_decisions_equal_jax_and_host():
    """(3,6) q4 min-LUT at 200 iterations: the converged / diverged
    decisions equal the JAX explorer's and the host engine's."""
    sigmas = np.array([0.82, 0.85, 0.88, 0.92])
    kw = dict(maxiter_de=200, Pe_max=1e-6, max_ni_de_iters=30)
    _, (ach, Pe, _), (ach_j, Pe_j, _) = run_both(kw, kw, sigmas)
    np.testing.assert_array_equal(ach, ach_j)
    assert_pe_equal(Pe, Pe_j)
    host = make_host(ens36())
    for s, a in zip(sigmas, ach):
        code, *_ = host.evolve(float(s))
        assert (code >= 0) == bool(a), (s, code, a)


def test_threshold_near_host_and_jax():
    """threshold(points=9, rounds=3) lies within 3e-3 of the host value
    and at the JAX explorer's final grid point or the one beside it."""
    port = DELutGPU(ens36(), maxiter_de=200, Pe_max=1e-6, max_ni_de_iters=30, device="cpu")
    jx = DELutTPU(ens36(True), maxiter_de=200, Pe_max=1e-6, max_ni_de_iters=30)
    thr = port.threshold(points=9, rounds=3)
    thr_j = jx.threshold(points=9, rounds=3)
    assert abs(thr - THR_36_Q4_200) < 3e-3, thr
    step = (port.thr_max - port.thr_min) / 8**3
    assert abs(thr - thr_j) <= step * (1 + 1e-9), (thr, thr_j)


def test_refine_host_handoff():
    """threshold(refine_host=True) finishes with the f64 engine inside the
    explorer's bracket and matches the full host search."""
    host = make_host(ens36())
    port = DELutGPU(ens36(), maxiter_de=200, Pe_max=1e-6, max_ni_de_iters=30,
                    host=host, device="cpu")
    thr = port.threshold(points=9, rounds=2, refine_host=True)
    host.set_bisec_window(max(host.thr_min, thr - 0.02), thr + 0.005)
    _, thr_full = host.bisec_search()
    assert thr_full > 0
    assert abs(thr - thr_full) < 2e-3, (thr, thr_full)


def test_irregular_joint_root_decisions():
    """The published irregular ensemble (VN 2, 3, 9, 17; CN 8, 9) through
    joint_root at 400 iterations: 0.89 converges and 0.96 diverges, as in
    JAX."""
    kw = dict(maxiter_de=400, Pe_max=1e-6, max_ni_de_iters=30)
    _, (ach, Pe, _), (ach_j, Pe_j, _) = run_both(
        kw, kw, [0.89, 0.96], JaxEnsemble.read(IRREGULAR), LDPCEnsemble.read(IRREGULAR))
    assert ach.tolist() == [True, False]
    np.testing.assert_array_equal(ach, ach_j)
    assert_pe_equal(Pe, Pe_j)


def test_reuse_zeros_matches_plain():
    """An all-zeros reuse matrix reproduces the plain evolve."""
    port = DELutGPU(ens36(), maxiter_de=30, Pe_max=1e-6, max_ni_de_iters=30, device="cpu")
    Pe0, it0 = port.prerank_reuse(0.80, np.zeros((1, 30), bool), pmax=1e-6)
    _, Pe_plain = port.evolve_batch(np.array([0.80]))
    np.testing.assert_allclose(Pe0, Pe_plain, rtol=1e-4)
    assert it0[0] < 30


def reuse_ranks(M, pmax=1e-17):
    """Final Pe of four single-reuse candidates at sigma 0.80 from the port,
    the JAX explorer and the f64 host engine."""
    cands = np.zeros((4, M), bool)
    for r, ii in enumerate((1, 3, 7, 10)):
        cands[r, ii] = True
    kw = dict(maxiter_de=M, Pe_max=1e-6, max_ni_de_iters=30)
    Pe, it_hit = DELutGPU(ens36(), device="cpu", **kw).prerank_reuse(0.80, cands, pmax)
    Pe_j, it_j = DELutTPU(ens36(True), **kw).prerank_reuse(0.80, cands, pmax)
    host = make_host(ens36(), maxiter=M)
    host.Pe_max = pmax
    host_Pe = []
    for rv in cands:
        host.reuse_vec = rv.copy()
        _, _, tr, _, _ = host.evolve(0.80, var_trace=True)
        host_Pe.append(tr[-1])
    return (Pe, it_hit), (Pe_j, it_j), np.array(host_Pe)


def test_reuse_ranking_matches_jax_and_host():
    """The f32 ranking of single-reuse candidates (what reuse_vec_opt
    --accel trims with) equals JAX's and the f64 host engine's at a depth
    where every Pe lies above the f32 floor (12 iterations, Pe about
    5e-4), with Pe within rtol 1e-3 of JAX's.  At the JAX test's depth (30
    iterations) every candidate's Pe is below 1e-20 on both explorers: the
    float32 noise regime of ROADMAP §C12, where no ranking is held."""
    (Pe, it_hit), (Pe_j, it_j), host_Pe = reuse_ranks(12)
    assert (Pe > 1e-4).all()
    order = list(np.argsort(Pe, kind="stable"))
    assert order == list(np.argsort(Pe_j, kind="stable"))
    assert order == list(np.argsort(host_Pe, kind="stable"))
    np.testing.assert_allclose(Pe, Pe_j, rtol=1e-3)
    np.testing.assert_array_equal(it_hit, it_j)
    assert Pe[0] > Pe[-1]  # reuse hurts; later reuse hurts less
    (Pe, _), (Pe_j, _), _ = reuse_ranks(30)
    assert (Pe < 1e-20).all() and (Pe_j < 1e-20).all()


def test_reuse_mixed_resolutions():
    """Nq_Cha != Nq_Msg: the channel-leaf join's product alphabet is
    K * Nq_Cha; the zeros row matches the plain evolve."""
    M = 12
    port = DELutGPU(ens36(), Nq_Cha=32, Nq_Msg=16, maxiter_de=M, Pe_max=1e-6,
                    max_ni_de_iters=30, device="cpu")
    rm = np.zeros((2, M), bool)
    rm[1, 2] = True
    Pe, _ = port.prerank_reuse(0.80, rm, pmax=1e-6)
    assert Pe[1] >= Pe[0]
    _, Pe_plain = port.evolve_batch(np.array([0.80]))
    np.testing.assert_allclose(Pe[0], Pe_plain[0], rtol=3e-3)


def test_reuse_refusals():
    """Reuse pre-ranking refuses full-LUT mode, a non-uniform resolution and
    reuse at iteration 0."""
    with pytest.raises(NotImplementedError):
        DELutGPU(ens36(), maxiter_de=10, min_lut=False, device="cpu").prerank_reuse(
            0.8, np.zeros((1, 10), bool))
    with pytest.raises(NotImplementedError):
        DELutGPU(ens36(), Nq_Msg=np.array([16] * 5 + [8] * 5), maxiter_de=10,
                 device="cpu").prerank_reuse(0.8, np.zeros((1, 10), bool))
    rm = np.zeros((1, 10), bool)
    rm[0, 0] = True
    with pytest.raises(ValueError):
        DELutGPU(ens36(), maxiter_de=10, device="cpu").prerank_reuse(0.8, rm)


def test_constructor_checks():
    with pytest.raises(ValueError):
        DELutGPU(ens36(), strategy="flat", device="cpu")
    with pytest.raises(ValueError):
        DELutGPU(ens36(), Nq_Msg=np.full(5, 16), maxiter_de=10, device="cpu")
    deg1 = LDPCEnsemble(np.array([1, 3]), np.array([0.1, 0.9]), np.array([6]), np.array([1.0]))
    with pytest.raises(NotImplementedError):
        DELutGPU(deg1, Nq_Cha=32, Nq_Msg=16, device="cpu")


def test_cuda_requested_without_card_raises():
    """The explorer resolves its device: CUDA asked for where there is none
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        DELutGPU(ens36())


@pytest.mark.parametrize("path", ["uniform", "segmented", "reuse"])
def test_flag_read_every_k_equals_every_iteration(path):
    """Reading the done flag every 7 iterations gives the outputs of a read
    every iteration: ach, Pe and the latched it / it_hit are equal."""
    M = 40
    out = []
    for k in (1, 7):
        if path == "segmented":
            port = DELutGPU(ens36(), Nq_Msg=np.array([16] * 17 + [8] * 23), maxiter_de=M,
                            Pe_max=1e-6, max_ni_de_iters=30, device="cpu")
        else:
            port = DELutGPU(ens36(), maxiter_de=M, Pe_max=1e-6, max_ni_de_iters=3,
                            device="cpu")
        port.sync_every = k
        if path == "reuse":
            rm = np.zeros((3, M), bool)
            rm[1, 5] = rm[2, 9] = True
            out.append(port.prerank_reuse(0.80, rm, pmax=1e-6))
        else:
            v2c, cha = port.channel_pmfs([0.70, 0.80, 0.86, 0.95])
            out.append([t.numpy() for t in port.evolve(v2c, cha)])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
