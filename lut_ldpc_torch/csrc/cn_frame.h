// The CN update of one check for one frame, written once for the card and
// for the host.
//
// What lut_ldpc_tpu/decoder/qc_kernels.py::_cn_qc_kernel and ::_cn_std_kernel
// compute per check and frame: over the d inputs the running min1 / min2 of
// the magnitudes and the parity of the signs, in float32; then
// out_k = (|x_k| == min1 ? min2 : min1), negated where parity ^ sign(x_k);
// int16 storage rounds to nearest even.  The CN frames of cn_frames.cuh call
// cn_frame from their kernels.  Compiled by a host C++ compiler (no
// __CUDACC__), the same function gets the entry point lut_cn_host_eval,
// which is how the CPU tests hold it against the plain version
// (tests/test_torch_cn_frame.py).
//
// Degrees 1 to kExact are instantiated exactly (x[] is d values, every guard
// folds away); wider checks go to a bucket of width 12, 16 or 40 that takes
// the degree at run time.  The widest bucket serves the 10GBase-T (6,32)
// code's checks of degree 31-33: at one frame a thread ptxas gave the std
// kernel's int16 instantiation 193 registers and no spill at width 40, where
// width 32 spilled (8 B stack) and width 64 too (255 registers).

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define LUT_CN_FN __device__ __forceinline__
#else
#define LUT_CN_FN inline
#endif

namespace lutcn {

constexpr int kExact = 10;      // widest degree instantiated exactly
constexpr int kMaxDegree = 40;  // widest bucket

// Instantiation width of a check degree (0: none)
constexpr int width_of(int d) {
  return d < 1            ? 0
         : d <= kExact     ? d
         : d <= 12         ? 12
         : d <= 16         ? 16
         : d <= kMaxDegree ? kMaxDegree
                           : 0;
}

#define LUT_CN_FOR_WIDTHS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(12) X(16) X(40)

template <typename T>
LUT_CN_FN T store_as(float v);
template <>
LUT_CN_FN float store_as<float>(float v) {
  return v;
}
template <>
LUT_CN_FN int16_t store_as<int16_t>(float v) {
#ifdef __CUDACC__
  return static_cast<int16_t>(__float2int_rn(v));
#else
  return static_cast<int16_t>(lrintf(v));  // the default mode: to nearest even
#endif
}

// x[0, d) in, the d outputs out (in place); returns the parity of the input
// signs.  W: the instantiation's width; d == W when W <= kExact.
template <int W>
LUT_CN_FN bool cn_frame(float (&x)[W], int d) {
  if (W <= kExact) d = W;
  float min1 = fabsf(x[0]), min2 = INFINITY;
  bool par = x[0] < 0.f;
#pragma unroll
  for (int k = 1; k < W; ++k) {
    if (k < d) {
      const float mag = fabsf(x[k]);
      par = par != (x[k] < 0.f);
      min2 = fminf(min2, fmaxf(min1, mag));
      min1 = fminf(min1, mag);
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k < d) {
      const float tmp = fabsf(x[k]) == min1 ? min2 : min1;
      x[k] = (par != (x[k] < 0.f)) ? -tmp : tmp;
    }
  }
  return par;
}

}  // namespace lutcn

#ifndef __CUDACC__
// Host build: n checks of degree d, x and out (d, n) row-major, out after the
// storage type's rounding (int16 when as_int16), par (n,) 0 or 1.  Returns -1
// for a degree without an instantiation.
extern "C" int lut_cn_host_eval(int d, int as_int16, const float* x, float* out,
                                uint8_t* par, int n) {
  switch (lutcn::width_of(d)) {
#define LUT_CN_CASE(W)                                                       \
  case W:                                                                    \
    for (int j = 0; j < n; ++j) {                                            \
      float v[W] = {};                                                       \
      for (int k = 0; k < d; ++k) v[k] = x[k * n + j];                       \
      par[j] = lutcn::cn_frame<W>(v, d) ? 1 : 0;                             \
      for (int k = 0; k < d; ++k)                                            \
        out[k * n + j] = as_int16 ? lutcn::store_as<int16_t>(v[k]) : v[k];   \
    }                                                                        \
    return 0;
    LUT_CN_FOR_WIDTHS(LUT_CN_CASE)
#undef LUT_CN_CASE
  }
  return -1;
}
#endif
