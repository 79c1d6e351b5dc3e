"""BPSK/AWGN channel ops on the device (port of lut_ldpc_tpu/sim/channel.py).

IT++ conventions (used throughout the reference): BPSK maps bit 0 -> +1,
bit 1 -> -1; N0 = 10^(-EbN0dB/10)/rate, noise variance N0/2 per dimension,
soft demodulation LLR = 4y/N0 = 2y/sigma^2 with positive LLR favoring bit 0.

float32 throughout, as in the JAX package, where `sigma` is a traced
float32: pass it as a 0-d float32 tensor, so that `sigma * sigma` is
rounded to float32 as there (a Python float would square in float64 and
round once, which can move an LLR by one ulp and a label across a
quantizer boundary).  Noise comes from a caller's ``torch.Generator``;
the CPU and a CUDA device draw different streams for one seed.
"""

from __future__ import annotations

import torch

__all__ = ["bpsk_modulate", "awgn", "llr_from_rx", "bpsk_awgn_llr"]


def bpsk_modulate(bits: torch.Tensor) -> torch.Tensor:
    return 1.0 - 2.0 * bits.to(torch.float32)


def awgn(generator: torch.Generator, s: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    noise = torch.randn(s.shape, generator=generator, dtype=s.dtype, device=s.device)
    return s + sigma * noise


def llr_from_rx(y: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return 2.0 * y / (sigma * sigma)


def bpsk_awgn_llr(generator: torch.Generator, bits: torch.Tensor, sigma: torch.Tensor):
    """bits (B, N) -> (llr (B, N) float32, y (B, N) float32)."""
    y = awgn(generator, bpsk_modulate(bits), sigma)
    return llr_from_rx(y, sigma), y
