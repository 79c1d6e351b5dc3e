"""The CN update of the CN frames (``lut_ldpc_torch/csrc/cn_frame.h``),
compiled as host C++ with ``g++ -O2 -ffp-contract=off``, against the plain
version ``qc_kernels._cn_compute``.

Every check degree from 2 to 40 (the exact instantiations up to 10 and the
three run-time-degree buckets above), degree 1 in float32, both storage types;
values drawn from a small alphabet so that ties at min1 == min2, zeros and
repeated magnitudes are common.  Tolerance: zero (outputs and parity
identical).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lut_ldpc_torch.decoder import qc_kernels as qk
from lut_ldpc_torch.decoder.nvcc import CSRC_DIR

N = 257  # checks a call


@pytest.fixture(scope="module")
def host_cn(tmp_path_factory):
    """lut_cn_host_eval of cn_frame.h compiled for the host."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    tmp = tmp_path_factory.mktemp("cn_host")
    lib = tmp / "libcn_host.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-x", "c++",
                    "-o", str(lib), os.path.join(CSRC_DIR, "cn_frame.h")],
                   check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    fp = ctypes.POINTER(ctypes.c_float)
    h.lut_cn_host_eval.argtypes = [ctypes.c_int, ctypes.c_int, fp, fp,
                                   ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    h.lut_cn_host_eval.restype = ctypes.c_int
    return h


def _run(h, x, as_int16):
    d, n = x.shape
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(x)
    par = np.empty(n, np.uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = h.lut_cn_host_eval(d, int(as_int16), x.ctypes.data_as(fp), out.ctypes.data_as(fp),
                            par.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)
    assert rc == 0
    return out, par.astype(bool)


def _values(rng, d, dtype):
    if dtype == np.int16:
        alphabet = np.array([-32767, -9, -3, -1, 0, 1, 3, 9, 32767], np.float32)
    else:
        alphabet = np.array([-2.5, -1.25, -0.5, -0.0, 0.0, 0.5, 1.25, 2.5,
                             np.finfo(np.float32).max], np.float32)
    return alphabet[rng.integers(0, len(alphabet), (d, N))]


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("d", list(range(2, qk.MAX_CN_DEGREE + 1)))
def test_cn_frame_equals_plain_version(host_cn, d, dtype):
    x = _values(np.random.default_rng(d), d, dtype)
    x[:, 0] = 3.0   # all magnitudes equal: min1 == min2 everywhere
    x[:, 1] = 0.0   # all zero
    x[0, 2], x[1:, 2] = 1.0, 9.0  # one smallest, the rest tied
    out, par = _run(host_cn, x, dtype == np.int16)
    want, wpar = qk._cn_compute(torch.as_tensor(x)[:, None, :])
    np.testing.assert_array_equal(out, want[:, 0].numpy().astype(dtype).astype(np.float32))
    np.testing.assert_array_equal(par, wpar[0].numpy())
    assert par.any() and not par.all()


def test_cn_frame_degree_one_and_limits(host_cn):
    """A single input: min2 stays infinite, and so does the output (float32);
    degrees 0 and 65 (above the widest bucket) have no instantiation."""
    x = np.array([[-2.5, 0.0, 1.25]], np.float32)
    out, par = _run(host_cn, x, False)
    want, wpar = qk._cn_compute(torch.as_tensor(x)[:, None, :])
    np.testing.assert_array_equal(out, want[:, 0].numpy())
    np.testing.assert_array_equal(par, wpar[0].numpy())
    fp = ctypes.POINTER(ctypes.c_float)
    for d in (0, qk.MAX_CN_DEGREE + 1):
        assert host_cn.lut_cn_host_eval(d, 0, fp(), fp(), None, 0) == -1


def test_int16_store_rounds_to_nearest_even(host_cn):
    """The int16 store (__float2int_rn on the card, lrintf here) rounds half
    to even; the kernels only ever store integers, but the rule is the
    card's."""
    x = np.array([[2.5, -3.5, 4.5], [7.0, 7.0, 7.0]], np.float32)
    out, _ = _run(host_cn, x, True)
    np.testing.assert_array_equal(out, [[7.0, 7.0, 7.0], [2.0, -4.0, 4.0]])
