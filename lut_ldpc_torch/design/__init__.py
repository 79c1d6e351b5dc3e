"""Decoder design: the host f64 density-evolution engines (de.DELut,
de_bp.DEBp), the LUT tree templates (templates), and the batched float32
explorers that evolve a whole sigma grid on a device (de_lut_gpu.DELutGPU,
de_bp_gpu.DEBpGPU; ports of lut_ldpc_tpu/design/de_lut_tpu.py and
de_bp_tpu.py)."""

from .de import DELut
from .de_bp import DEBp
from .de_bp_gpu import DEBpGPU
from .de_lut_gpu import DELutGPU

__all__ = ["DEBp", "DEBpGPU", "DELut", "DELutGPU"]
