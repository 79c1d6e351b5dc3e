"""Experiment configuration mirroring the reference's INI key surface
(copy of lut_ldpc_tpu/sim/config.py; numpy only).

The reference drives simulations with boost ptree INI files, sections
[Sim] [LDPC] [BP] [LUT] (the reference's src/LDPC_BER_Sim.cpp:42-102,
376-430).  We keep those keys as the canonical vocabulary: dataclasses carry
the same names/defaults, and parse_ini() reads the reference's files
unchanged (presence of a [LUT] vs [BP] section selects the decoder family,
prog/ber_sim.cpp:136-147).
"""

from __future__ import annotations

import configparser
from dataclasses import dataclass, field

import numpy as np

__all__ = ["SimConfig", "LDPCConfig", "BPConfig", "LUTConfig", "BERSimConfig", "parse_ini"]


def _parse_range(s: str) -> np.ndarray:
    """MATLAB-style 'start:step:stop' or space/comma separated list."""
    s = s.strip()
    if ":" in s:
        parts = [float(x) for x in s.split(":")]
        if len(parts) == 2:
            start, stop = parts
            step = 1.0
        else:
            start, step, stop = parts
        n = int(np.floor((stop - start) / step + 1e-9)) + 1
        return start + step * np.arange(n)
    return np.array([float(x) for x in s.replace(",", " ").split()])


@dataclass
class SimConfig:
    """[Sim] section (LDPC_BER_Sim.cpp:50-78)."""

    SNRdB: np.ndarray = field(default_factory=lambda: np.arange(0.0, 4.5, 0.5))
    Nframes: int = 10000
    Nfers: int = 100
    ber_min: float = 1e-7
    fer_min: float = 1e-9
    rand_seed_offset: int = 0
    rand_seed: int = 0
    save_codec: int = -1  # only the run with seed == save_codec writes the codec
    results_prefix: str = "RES"
    results_dir: str = "results"
    codes_dir: str = "codes"
    codec_filename: str = ""
    custom_name: str = ""
    batch_size: int = 128  # frames per device step (no INI analog in the reference)


@dataclass
class LDPCConfig:
    """[LDPC] section."""

    parity_filename: str = ""
    zero_codeword: bool = True
    save_permuted: bool = False
    parity_check_iter: bool = True
    # qc_detect=1: factorize a DVB-S2-family 360-periodic matrix into its
    # quasi-cyclic form (core/dvbs2.py) so decoding rides the QC kernels.
    # Statistically identical (same code up to bit relabeling; the LUT-tree
    # leaf order follows circulant slot order, equivalent to feeding the
    # reference the permuted alist) but not
    # frame-bit-identical to the unpermuted realization — default off to
    # keep result files reproducible against earlier runs.
    qc_detect: bool = False
    qc_detect_Z: int = 360  # circulant size to try (the ETSI standard's 360)


@dataclass
class BPConfig:
    """[BP] section.  qllr_* mirror the LLR_calc_unit resolution knobs
    (LDPC_BER_Sim.cpp:74-78); algorithm extends the surface with the usual
    min-sum variants."""

    max_iter: int = 50
    algorithm: str = "spa"  # spa | minsum | nms | oms
    scale: float = 0.75
    offset: float = 0.15
    qllr_total_bits: int = 0  # 0 = float BP
    qllr_frac_bits: int = 0
    qllr_table_size: int = 0
    qllr_table_frac_bits: int = 0


@dataclass
class LUTConfig:
    """[LUT] section (LDPC_BER_Sim.cpp:376-430)."""

    max_iter: int = 50
    design_thr: float = 0.0  # design noise stdev; 0 = use design_SNRdB
    design_SNRdB: float = 0.0
    qbits_channel: int = 4
    qbits_message_uniform: int = 4
    # optional per-iteration message bit widths, e.g. "4 4 3 3 2" (one entry
    # per iteration; LDPC_BER_Sim.cpp:398 'LUT.qbits_messages' — overrides
    # qbits_message_uniform when non-empty)
    qbits_messages: str = ""
    tree_mode: str = "auto_bin_balanced"  # auto modes | 'file'
    trees_filename: str = ""
    trees_dir: str = "trees"  # search dir for tree_mode=file (cpp:409)
    min_lut: bool = True
    reuse_lut: str = ""  # e.g. '0 1 1 0 ...' per-iteration reuse flags
    output_verbosity: int = 0
    initial_message_mode: str = "cont"  # cont | qcha
    irregular_design_strategy: str = "joint_root"


@dataclass
class BERSimConfig:
    sim: SimConfig = field(default_factory=SimConfig)
    ldpc: LDPCConfig = field(default_factory=LDPCConfig)
    bp: BPConfig | None = None
    lut: LUTConfig | None = None

    @property
    def codec_type(self) -> str:
        if self.lut is not None:
            return "LUT"
        return "BP"


def parse_ini(path: str) -> BERSimConfig:
    cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    cp.optionxform = str
    with open(path) as f:
        cp.read_string(f.read())

    def get(section, key, default, cast=str):
        if cp.has_section(section) and cp.has_option(section, key):
            v = cp.get(section, key).strip()
            if cast is bool:
                return v.lower() in ("1", "true", "yes", "on")
            return cast(v)
        return default

    sd = SimConfig()
    sim = SimConfig(
        SNRdB=_parse_range(get("Sim", "SNRdB", "0:0.5:4")),
        Nframes=get("Sim", "Nframes", sd.Nframes, int),
        Nfers=get("Sim", "Nfers", sd.Nfers, int),
        ber_min=get("Sim", "ber_min", sd.ber_min, float),
        fer_min=get("Sim", "fer_min", sd.fer_min, float),
        rand_seed_offset=get("Sim", "rand_seed_offset", sd.rand_seed_offset, int),
        save_codec=get("Sim", "save_codec", sd.save_codec, int),
        results_prefix=get("Sim", "results_prefix", sd.results_prefix),
        results_dir=get("Sim", "results_dir", sd.results_dir),
        codes_dir=get("Sim", "codes_dir", sd.codes_dir),
        codec_filename=get("Sim", "codec_filename", sd.codec_filename),
        custom_name=get("Sim", "custom_name", sd.custom_name),
        batch_size=get("Sim", "batch_size", sd.batch_size, int),
    )
    ld = LDPCConfig()
    ldpc = LDPCConfig(
        parity_filename=get("LDPC", "parity_filename", ld.parity_filename),
        zero_codeword=get("LDPC", "zero_codeword", ld.zero_codeword, bool),
        save_permuted=get("LDPC", "save_permuted", ld.save_permuted, bool),
        parity_check_iter=get("LDPC", "parity_check_iter", ld.parity_check_iter, bool),
        qc_detect=get("LDPC", "qc_detect", ld.qc_detect, bool),
        qc_detect_Z=get("LDPC", "qc_detect_Z", ld.qc_detect_Z, int),
    )
    bp = lut = None
    codec_type = get("Sim", "codec_type", "")
    if cp.has_section("LUT") or codec_type == "LUT":
        lc = LUTConfig()
        lut = LUTConfig(
            max_iter=get("LUT", "max_iter", lc.max_iter, int),
            design_thr=get("LUT", "design_thr", lc.design_thr, float),
            design_SNRdB=get("LUT", "design_SNRdB", lc.design_SNRdB, float),
            qbits_channel=get("LUT", "qbits_channel", lc.qbits_channel, int),
            qbits_message_uniform=get(
                "LUT", "qbits_message_uniform", lc.qbits_message_uniform, int
            ),
            qbits_messages=get("LUT", "qbits_messages", lc.qbits_messages),
            tree_mode=get("LUT", "tree_mode", lc.tree_mode),
            trees_filename=get("LUT", "trees_filename", lc.trees_filename),
            trees_dir=get("LUT", "trees_dir", lc.trees_dir),
            min_lut=get("LUT", "min_lut", lc.min_lut, bool),
            reuse_lut=get("LUT", "reuse_lut", lc.reuse_lut),
            output_verbosity=get("LUT", "output_verbosity", lc.output_verbosity, int),
            initial_message_mode={
                # reference spellings (LDPC_BER_Sim.cpp:428-430)
                "from_continuous_input": "cont",
                "from_quantized_channel_llrs": "qcha",
            }.get(
                get("LUT", "initial_message_mode",
                    lc.initial_message_mode).lower(),
                get("LUT", "initial_message_mode",
                    lc.initial_message_mode).lower(),
            ),
            irregular_design_strategy=get(
                "LUT", "irregular_design_strategy", lc.irregular_design_strategy
            ),
        )
    elif cp.has_section("BP") or codec_type == "BP":
        bc = BPConfig()
        bp = BPConfig(
            max_iter=get("BP", "max_iter", bc.max_iter, int),
            algorithm=get("BP", "algorithm", bc.algorithm),
            scale=get("BP", "scale", bc.scale, float),
            offset=get("BP", "offset", bc.offset, float),
            qllr_total_bits=get("BP", "qllr_total_bits", bc.qllr_total_bits, int),
            qllr_frac_bits=get("BP", "qllr_frac_bits", bc.qllr_frac_bits, int),
            qllr_table_size=get("BP", "qllr_table_size", bc.qllr_table_size, int),
            qllr_table_frac_bits=get(
                "BP", "qllr_table_frac_bits", bc.qllr_table_frac_bits, int
            ),
        )
    else:
        bp = BPConfig()
    return BERSimConfig(sim=sim, ldpc=ldpc, bp=bp, lut=lut)
