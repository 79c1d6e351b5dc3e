"""Shared helpers of the DE-LUT explorer tests (tests/test_torch_de_lut.py,
tests/test_torch_de_lut_modes.py): ensembles, the host engine, and one
evolve of the port and of the JAX explorer on the same float32 pmfs."""

import numpy as np
import jax.numpy as jnp

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble as JaxEnsemble
from lut_ldpc_tpu.design.de_lut_tpu import DELutTPU
from lut_ldpc_torch.core.ensemble import LDPCEnsemble
from lut_ldpc_torch.design.de import DELut
from lut_ldpc_torch.design.de_lut_gpu import DELutGPU
from lut_ldpc_torch.design.templates import get_lut_tree_templates

# host-measured (3,6) q4 min-LUT threshold at 200 DE iterations (BASELINE.md
# round 1; tests/test_de_lut_tpu.py)
THR_36_Q4_200 = 0.864391


def ens36(jax_side=False):
    cls = JaxEnsemble if jax_side else LDPCEnsemble
    return cls(np.array([3]), np.array([1.0]), np.array([6]), np.array([1.0]))


def make_host(ens, maxiter=200, Nq=16, min_lut=True):
    nq_vec = np.full(maxiter, Nq, dtype=np.int64)
    var_luts, chk_luts = get_lut_tree_templates(
        "auto_bin_balanced", ens, nq_vec, Nq, min_lut)
    de = DELut(ens, Nq, nq_vec, maxiter, var_luts, None if min_lut else chk_luts)
    de.set_exit_conditions(max_ni_de_iters=30, Pe_max=1e-6, thr_prec=1e-4)
    return de


def run_both(jax_kw, port_kw, sigmas, jax_ens=None, port_ens=None):
    """(port, jax) explorers and their (ach, Pe, it) on the same float32
    pmfs (designed once by the port)."""
    port = DELutGPU(port_ens or ens36(), device="cpu", **port_kw)
    jx = DELutTPU(jax_ens or ens36(True), **jax_kw)
    v2c, cha = port.channel_pmfs(sigmas)
    out_p = [t.numpy() for t in port.evolve(v2c, cha)]
    out_j = [np.asarray(t) for t in jx._evolve(jnp.asarray(v2c.numpy()),
                                                jnp.asarray(cha.numpy()))]
    return port, out_p, out_j


def assert_pe_equal(Pe, Pe_jax, Pe_max=1e-6):
    """rtol 1e-3 above the f32 floor; below it both under Pe_max (ROADMAP
    §C12)."""
    above = Pe_jax >= Pe_max
    np.testing.assert_allclose(Pe[above], Pe_jax[above], rtol=1e-3)
    assert (Pe[~above] < Pe_max).all(), (Pe, Pe_jax)
