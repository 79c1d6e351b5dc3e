"""Explicit device resolution: nothing in the port picks a device for the
caller, and asking for CUDA where there is none raises instead of quietly
running on the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cpu", "cuda", "cuda:1", a torch.device).
    A bare "cuda" resolves to the current CUDA device index."""
    if device is None:
        raise ValueError("device is required (e.g. 'cuda' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev
