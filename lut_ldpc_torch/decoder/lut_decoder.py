"""Label-domain min-LUT check-node update (port of
lut_ldpc_tpu/decoder/lut_decoder.py ``cn_minsum``).  The unrolled
``LUTDecoder`` itself is ROADMAP A8."""

from __future__ import annotations

import torch

__all__ = ["cn_minsum"]


def cn_minsum(m: torch.Tensor, nz: int) -> torch.Tensor:
    """Min-sum CN update over the last axis on integer labels in
    [0, 2*nz): out_i = sign parity excluding i times min_{j != i} of the
    magnitudes, via prefix/suffix minima (LDPC_Code_LUT.cpp:355-402;
    degree-1 nodes get the nz initialization).  Same dtype as m."""
    d = m.shape[-1]
    neg = m < nz
    mag = torch.where(neg, nz - 1 - m, m - nz)
    fill = torch.full(m.shape[:-1], nz, dtype=mag.dtype, device=m.device)
    pre = [fill]
    for j in range(d - 1):
        pre.append(torch.minimum(pre[-1], mag[..., j]))
    suf = [fill]
    for j in range(d - 1, 0, -1):
        suf.append(torch.minimum(suf[-1], mag[..., j]))
    suf = suf[::-1]
    tmp = torch.stack([torch.minimum(pre[j], suf[j]) for j in range(d)], dim=-1)
    sign_prod = neg.sum(dim=-1, keepdim=True) & 1
    flip = (sign_prod == 1) ^ neg
    return torch.where(flip, nz - 1 - tmp, nz + tmp).to(m.dtype)
