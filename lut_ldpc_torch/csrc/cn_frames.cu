// The CN frames of one message storage type as a translation unit of its
// own: lut_ldpc_torch/decoder/qc_kernels.py builds it twice, side by side,
// with -DLUT_CN_STORAGE=int16_t and with -DLUT_CN_STORAGE=float.
#include "cn_frames.cuh"
