"""The Monte-Carlo BER simulator on one device (port of lut_ldpc_tpu/sim):
``BERSim`` and ``run_from_config``, the device-side channel, and copies of
the numpy modules (INI configuration, results files, analysis)."""

from .analysis import analyze_results, ber_limit_curve, c_awgn, c_biawgn
from .ber_sim import BERSim, run_from_config
from .channel import awgn, bpsk_awgn_llr, bpsk_modulate, llr_from_rx
from .config import BERSimConfig, BPConfig, LDPCConfig, LUTConfig, SimConfig, parse_ini
from .results import BERSimResults, aggregate

__all__ = [
    "BERSim",
    "analyze_results",
    "ber_limit_curve",
    "c_awgn",
    "c_biawgn",
    "BERSimConfig",
    "BERSimResults",
    "BPConfig",
    "LDPCConfig",
    "LUTConfig",
    "SimConfig",
    "aggregate",
    "awgn",
    "bpsk_awgn_llr",
    "bpsk_modulate",
    "llr_from_rx",
    "parse_ini",
    "run_from_config",
]
