// CN and VN passes of the quasi-cyclic LUT decode for Hopper (sm_90a).
//
// Replaces lut_ldpc_tpu/decoder/qc_kernels.py::cn_qc_pass (Pallas body
// _cn_qc_kernel) and ::vn_qc_pass (_vn_qc_kernel / _vn_class_compute).
// What they compute is kept; the TPU schedule (halo planes, 8-row realign,
// double-buffered window DMAs, SMEM step tables) is not.  Messages stay in
// the standard slot-major grouped layout, (rows, B) with the frame axis B
// contiguous, and a circulant shift is a modular row index in the load.
//
// Bound: bytes.  Each pass streams int16 (or f32) messages once in and once
// out and does little arithmetic per byte.  One thread owns one
// (block-row, z, frame) triple; threads of a warp take consecutive frames,
// so every load and store is a coalesced row segment.  Per-iteration VN
// parameters are staged in shared memory once per thread block.
//
// Arithmetic is float32 for both storage types (int16 values are exact in
// float32); build with --fmad=false and without fast-math: float32 specs
// are proven exact for left-to-right sums only.
//
// C entry points return cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVals = 64;  // leaves + ops of one VN tree

template <typename T>
__device__ __forceinline__ T to_store(float v);
template <>
__device__ __forceinline__ int16_t to_store<int16_t>(float v) {
  return static_cast<int16_t>(__float2int_rn(v));
}
template <>
__device__ __forceinline__ float to_store<float>(float v) {
  return v;
}

// CN update: running min1/min2 and sign parity over the dc inputs,
// out_k = (|x_k| == min1 ? min2 : min1) signed by parity ^ sign(x_k);
// the per-frame syndrome flag is cleared where the input parity is odd.
template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
cn_qc_kernel(const T* __restrict__ m_vn, T* __restrict__ m_cn,
             uint8_t* __restrict__ synd, const int* __restrict__ src,
             const int* __restrict__ shift, const int* __restrict__ dst,
             const int* __restrict__ deg, int Z, int maxd, int B, int nbx) {
  const int node = blockIdx.x / nbx;
  const int b = (blockIdx.x - node * nbx) * kThreads + threadIdx.x;
  if (b >= B) return;
  const int r = node / Z;
  const int z = node - r * Z;
  const int d = deg[r];
  const int* src_r = src + r * maxd;
  const int* sh_r = shift + r * maxd;
  const int* dst_r = dst + r * maxd;

  float x[MAXD];
  float min1 = INFINITY, min2 = INFINITY;
  bool par = false;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k < d) {
      int zz = z + sh_r[k];
      if (zz >= Z) zz -= Z;
      const float v = static_cast<float>(
          m_vn[static_cast<size_t>(src_r[k] + zz) * B + b]);
      x[k] = v;
      const float mag = fabsf(v);
      par = par != (v < 0.f);
      if (k == 0) {
        min1 = mag;
      } else {
        min2 = fminf(min2, fmaxf(min1, mag));
        min1 = fminf(min1, mag);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k < d) {
      const float tmp = (fabsf(x[k]) == min1) ? min2 : min1;
      const bool flip = par ^ (x[k] < 0.f);
      m_cn[static_cast<size_t>(dst_r[k] + z) * B + b] =
          to_store<T>(flip ? -tmp : tmp);
    }
  }
  if (par) synd[b] = 0;
}

// VN update: for each output edge i, the class's threshold tree evaluated
// on the leave-one-out leaves (messages other than i, then the channel).
// Each op sums its operands left to right, emits through the select chain
// out = lev[0]; out = lev[t+1] where x >= thr[t]; sym ops chain on |s| and
// restore the sign; tie ops emit tie_lo/tie_hi at s == 0 by the sign of
// the last operand.  Writes the hard bit (sign of output 0) and clears the
// frame's unanimity flag where the output signs disagree.
template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
vn_qc_kernel(const T* __restrict__ m_cn, const T* __restrict__ cha,
             T* __restrict__ m_vn, int8_t* __restrict__ bits,
             uint8_t* __restrict__ unan, const int* __restrict__ src,
             const int* __restrict__ shift, const int* __restrict__ dst,
             const int* __restrict__ node_base,
             const int* __restrict__ row_cls, const int* __restrict__ cls_deg,
             const int* __restrict__ cls_op0, const int* __restrict__ cls_nops,
             const int* __restrict__ op_info, const int* __restrict__ opnds,
             const float* __restrict__ prm, int it, int prm_row, int Z,
             int maxd, int B, int nbx) {
  extern __shared__ float sprm[];
  for (int i = threadIdx.x; i < prm_row; i += kThreads)
    sprm[i] = prm[static_cast<size_t>(it) * prm_row + i];
  __syncthreads();

  const int node = blockIdx.x / nbx;
  const int b = (blockIdx.x - node * nbx) * kThreads + threadIdx.x;
  if (b >= B) return;
  const int r = node / Z;
  const int z = node - r * Z;
  const int c = row_cls[r];
  const int d = cls_deg[c];
  const int op0 = cls_op0[c];
  const int nops = cls_nops[c];
  const int* src_r = src + r * maxd;
  const int* sh_r = shift + r * maxd;
  const int* dst_r = dst + r * maxd;

  float msg[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k < d) {
      int zz = z + sh_r[k];
      if (zz >= Z) zz -= Z;
      msg[k] = static_cast<float>(
          m_cn[static_cast<size_t>(src_r[k] + zz) * B + b]);
    }
  }
  const float ch =
      static_cast<float>(cha[static_cast<size_t>(node_base[r] + z) * B + b]);

  bool neg0 = false, agree = true;
  float vals[kMaxVals];
  for (int i = 0; i < d; ++i) {
#pragma unroll
    for (int k = 0; k + 1 < MAXD; ++k) {
      if (k < d - 1) vals[k] = (k < i) ? msg[k] : msg[k + 1];
    }
    vals[d - 1] = ch;
    int nv = d;
    for (int o = 0; o < nops; ++o) {
      const int* oi = op_info + (op0 + o) * 5;
      const int os = oi[0], oc = oi[1], nthr = oi[2], fl = oi[3];
      const float* thr = sprm + oi[4];
      const float* lev = thr + nthr;
      float s = vals[opnds[os]];
      for (int q = 1; q < oc; ++q) s = s + vals[opnds[os + q]];
      const float x = (fl & 1) ? fabsf(s) : s;
      float out = lev[0];
      for (int t = 0; t < nthr; ++t) {
        if (x >= thr[t]) out = lev[t + 1];
      }
      if (fl & 1) out = (s < 0.f) ? -out : out;
      if ((fl & 2) && s == 0.f)
        out = (vals[opnds[os + oc - 1]] < 0.f) ? lev[nthr + 1] : lev[nthr + 2];
      vals[nv++] = out;
    }
    const float o_i = vals[nv - 1];
    m_vn[static_cast<size_t>(dst_r[i] + z) * B + b] = to_store<T>(o_i);
    const bool ni = o_i < 0.f;
    if (i == 0)
      neg0 = ni;
    else
      agree = agree && (ni == neg0);
  }
  bits[static_cast<size_t>(node_base[r] + z) * B + b] = neg0 ? 1 : 0;
  if (!agree) unan[b] = 0;
}

inline int blocks_x(int B) { return (B + kThreads - 1) / kThreads; }

template <typename T, int MAXD>
int launch_cn(const void* m_vn, void* m_cn, void* synd, const void* src,
              const void* shift, const void* dst, const void* deg, int R,
              int Z, int maxd, int B, void* stream) {
  const int nbx = blocks_x(B);
  cn_qc_kernel<T, MAXD><<<static_cast<unsigned>(R) * Z * nbx, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(m_vn), static_cast<T*>(m_cn),
      static_cast<uint8_t*>(synd), static_cast<const int*>(src),
      static_cast<const int*>(shift), static_cast<const int*>(dst),
      static_cast<const int*>(deg), Z, maxd, B, nbx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MAXD>
int launch_vn(const void* m_cn, const void* cha, void* m_vn, void* bits,
              void* unan, const void* src, const void* shift, const void* dst,
              const void* node_base, const void* row_cls, const void* cls_deg,
              const void* cls_op0, const void* cls_nops, const void* op_info,
              const void* opnds, const void* prm, int it, int prm_row, int R,
              int Z, int maxd, int B, void* stream) {
  const int nbx = blocks_x(B);
  const size_t smem = static_cast<size_t>(prm_row) * sizeof(float);
  vn_qc_kernel<T, MAXD><<<static_cast<unsigned>(R) * Z * nbx, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(m_cn), static_cast<const T*>(cha),
      static_cast<T*>(m_vn), static_cast<int8_t*>(bits),
      static_cast<uint8_t*>(unan), static_cast<const int*>(src),
      static_cast<const int*>(shift), static_cast<const int*>(dst),
      static_cast<const int*>(node_base), static_cast<const int*>(row_cls),
      static_cast<const int*>(cls_deg), static_cast<const int*>(cls_op0),
      static_cast<const int*>(cls_nops), static_cast<const int*>(op_info),
      static_cast<const int*>(opnds), static_cast<const float*>(prm), it,
      prm_row, Z, maxd, B, nbx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// maxd: row-table width (largest degree); 8 and 32 are instantiated.
int lut_cn_qc_pass(int is_f32, const void* m_vn, void* m_cn, void* synd,
                   const void* src, const void* shift, const void* dst,
                   const void* deg, int R, int Z, int maxd, int B,
                   void* stream) {
  if (maxd > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (is_f32)
    return maxd <= 8 ? launch_cn<float, 8>(m_vn, m_cn, synd, src, shift, dst,
                                           deg, R, Z, maxd, B, stream)
                     : launch_cn<float, 32>(m_vn, m_cn, synd, src, shift, dst,
                                            deg, R, Z, maxd, B, stream);
  return maxd <= 8 ? launch_cn<int16_t, 8>(m_vn, m_cn, synd, src, shift, dst,
                                           deg, R, Z, maxd, B, stream)
                   : launch_cn<int16_t, 32>(m_vn, m_cn, synd, src, shift, dst,
                                            deg, R, Z, maxd, B, stream);
}

int lut_vn_qc_pass(int is_f32, const void* m_cn, const void* cha, void* m_vn,
                   void* bits, void* unan, const void* src, const void* shift,
                   const void* dst, const void* node_base, const void* row_cls,
                   const void* cls_deg, const void* cls_op0,
                   const void* cls_nops, const void* op_info,
                   const void* opnds, const void* prm, int it, int prm_row,
                   int R, int Z, int maxd, int B, void* stream) {
  if (maxd > 32 || static_cast<size_t>(prm_row) * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
#define LUT_VN_ARGS                                                        \
  m_cn, cha, m_vn, bits, unan, src, shift, dst, node_base, row_cls, cls_deg, \
      cls_op0, cls_nops, op_info, opnds, prm, it, prm_row, R, Z, maxd, B,    \
      stream
  if (is_f32)
    return maxd <= 8 ? launch_vn<float, 8>(LUT_VN_ARGS)
                     : launch_vn<float, 32>(LUT_VN_ARGS);
  return maxd <= 8 ? launch_vn<int16_t, 8>(LUT_VN_ARGS)
                   : launch_vn<int16_t, 32>(LUT_VN_ARGS);
#undef LUT_VN_ARGS
}

}  // extern "C"
