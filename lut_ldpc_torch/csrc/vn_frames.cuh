// Kernel frames of the generated VN passes for Hopper (sm_90a).
//
// Included at the end of every translation unit that
// lut_ldpc_torch/decoder/vn_codegen.py writes for one arithmetic spec.  The
// unit holds, per degree class C of the spec, the leave-one-out threshold
// tree as straight-line float code (VnClass<C>::run: d message values and the
// channel value in, d outputs out, every intermediate a named float, every
// threshold and level read at a literal offset of VnClass<C>::Prm).  This
// file owns everything else: row addressing, loads, stores, hard bits,
// per-frame sign unanimity, the launch.
//
// Replaces lut_ldpc_tpu/decoder/qc_kernels.py::vn_qc_pass (Pallas body
// _vn_qc_kernel) and ::vn_std_pass (_vn_std_kernel); what they compute
// (_vn_class_compute: left-to-right float32 sums, select chain, sym, tie at
// s == 0, the two shared sweeps) is kept bit for bit, their TPU schedule
// (halo planes, realign, window DMAs, SMEM parameter refs) is not.  The
// block entry replaces lut_ldpc_tpu/decoder/pallas_kernels.py::vn_pass
// (_vn_kernel): one degree block's tree for every leave-one-out output
// through the block's index table, op 0 as total minus self under use_tot,
// merged into the same kind of straight-line program by vn_program.py.  The
// table-driven vn_qc_kernel / vn_std_kernel / vn_block_kernel of
// qc_kernels.cu compute the same from int tables with one binary for every
// codec; they keep their values in per-thread local memory and chase three
// dependent loads per operand.
//
// Bound: bytes (int16 or float32 messages once in and once out, channel
// values in, int8 bits out).  What the card really runs out of is its rate
// of compares and selects: an op evaluation is 7 to 15 of each, and an SM
// starts 64 lanes of them a clock, half the float32 add rate, so a class of
// degree 17 (96 op evaluations a node) takes three times its bytes time.
// What the design does about it:
//  - one kernel instantiation per (class, frames a thread): the tree is a
//    fixed expression, so every value lives in a register and each class
//    takes the registers its own tree needs, not the widest class's;
//  - the iteration's thresholds and levels of the class travel as a
//    __grid_constant__ kernel argument: each is an operand of its compare or
//    select in the constant bank, no load instruction, no shared-memory
//    staging and no barrier before the first message load; one binary still
//    serves every iteration;
//  - a thread owns V consecutive frames of one node (V by the class's
//    degree: 4 frames, 8- or 16-byte loads, up to degree 4, one frame above,
//    where the tree's live values fill the registers: two frames of a
//    degree-17 tree spill) and starts all its d + 1 loads before the
//    arithmetic starts; threads of a warp take consecutive frame groups, so
//    every access is a coalesced row segment;
//  - a resident grid walks the (node, frame chunk) items with a grid stride,
//    so no block is scheduled for a handful of loads.
// Any batch width works: V frames a thread need B % V == 0 and 16-byte
// aligned arrays; otherwise the one-frame instantiation runs.
//
// Arithmetic is float32 for both storage types; build with --fmad=false and
// without fast-math.  C entry points return cudaGetLastError() of the launch,
// or kNothingToLaunch where the launch would have no block: the caller counts
// a launch only where it saw 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace lutvn {

// Threads a block and frames a thread, settled on an H100 80GB HBM3 at
// 700 W on builds of this file with other values (PERF.md, section 6): 128
// threads were slower than 256
// (PEG int16 pass 5.620 against 5.085 ms); degree <= 4 (bound by bytes) at
// 2 / 4 / 8 frames a thread took 5.153 / 5.085 / 4.996 ms, and 4 is the
// widest that 16-byte alignment serves in both storage types; above degree 4
// more than one frame bought nothing (degree 8: 4.256 ms at 1, 4.531 at 2)
// and two frames of a degree-17 tree spill (3736 B of stack, 54.645 ms).
constexpr int kThreads = 256;
constexpr int kVecLow = 4;   // frames a thread, degree <= 4
constexpr int kVecHigh = 1;  // frames a thread above
constexpr int kNothingToLaunch = -1;  // no node or no frame: nothing launched

constexpr int vec_width(int d) { return d <= 4 ? kVecLow : kVecHigh; }

// V consecutive frames of one row, loaded and stored as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

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

// Row of slot k for one node: QC rows roll inside their circulant, std rows
// sit in the class's slot planes.
struct QcRows {
  const int* base;
  const int* shift;  // nullptr: no roll
  int z, Z;
  __device__ __forceinline__ int operator()(int k) const {
    int zz = z;
    if (shift != nullptr) {
      zz += shift[k];
      if (zz >= Z) zz -= Z;
    }
    return base[k] + zz;
  }
};

struct StdRows {
  int edge_start, n_pad, off;
  __device__ __forceinline__ int operator()(int k) const {
    return edge_start + k * n_pad + off;
  }
};

// Slot rows of a VN layout block read through a row table: slot row e of
// the block is row rows[e] of the input (the block loop's c2v gather:
// perm_c2v, the CN-grouped row of every VN-grouped edge row), or row e
// itself where rows is null (a stand-alone block).
struct GatherRows {
  const int* rows;
  StdRows slot;
  __device__ __forceinline__ int operator()(int k) const {
    const int e = slot(k);
    return rows != nullptr ? rows[e] : e;
  }
};

// One node, frames [b, b + V): all loads, then the class body per frame,
// then the stores.  nrow: the node's row of cha and bits.
template <typename T, int C, int V, typename Src, typename Dst>
__device__ __forceinline__ void vn_item(
    const T* __restrict__ m_in, const T* __restrict__ cha,
    T* __restrict__ m_out, int8_t* __restrict__ bits,
    uint8_t* __restrict__ unan, const Src& src, const Dst& dst, size_t nrow,
    int B, int b, const typename VnClass<C>::Prm& prm) {
  constexpr int D = VnClass<C>::D;
  using VT = Vec<T, V>;
  VT in[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    in[k] = *reinterpret_cast<const VT*>(
        m_in + static_cast<size_t>(src(k)) * B + b);
  const VT chv = *reinterpret_cast<const VT*>(cha + nrow * B + b);
  size_t orow[D];
#pragma unroll
  for (int k = 0; k < D; ++k) orow[k] = static_cast<size_t>(dst(k)) * B + b;

  VT out[D];
  Vec<int8_t, V> bitv;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float m[D], o[D];
#pragma unroll
    for (int k = 0; k < D; ++k) m[k] = static_cast<float>(in[k].v[v]);
    VnClass<C>::run(prm, m, static_cast<float>(chv.v[v]), o);
    const bool neg0 = o[0] < 0.f;
    bool agree = true;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      out[k].v[v] = to_store<T>(o[k]);
      if (k > 0) agree = agree && ((o[k] < 0.f) == neg0);
    }
    bitv.v[v] = neg0 ? 1 : 0;
    // every disagreeing node of a frame clears the same flag: look first,
    // so that a frame already cleared costs a cached load and no store
    if (!agree && unan[b + v] != 0) unan[b + v] = 0;
  }
#pragma unroll
  for (int k = 0; k < D; ++k) *reinterpret_cast<VT*>(m_out + orow[k]) = out[k];
  *reinterpret_cast<Vec<int8_t, V>*>(bits + nrow * B + b) = bitv;
}

// Frames of one item's thread; false past the batch's end.
template <int V>
__device__ __forceinline__ bool item_frames(long long item, int nchunks,
                                            int B, int* node, int* b) {
  const int it = static_cast<int>(item);
  *node = it / nchunks;
  *b = ((it - *node * nchunks) * kThreads + threadIdx.x) * V;
  return *b < B;
}

// ---------------------------------------------------------------------------
// quasi-cyclic graphs: block-rows [r_lo, r_lo + n_rows) of class C, Z nodes
// each; m_vn[dst + z] = tree(m_cn[src + (z + shift) % Z]), channel and bits
// row node_base + z
// ---------------------------------------------------------------------------
template <typename T, int C, int V>
__global__ void __launch_bounds__(kThreads)
vn_qc_class_kernel(const T* __restrict__ m_cn, const T* __restrict__ cha,
                   T* __restrict__ m_vn, int8_t* __restrict__ bits,
                   uint8_t* __restrict__ unan, const int* __restrict__ src,
                   const int* __restrict__ shift, const int* __restrict__ dst,
                   const int* __restrict__ node_base, int r_lo, int n_rows,
                   int Z, int maxd, int B, int nchunks,
                   const __grid_constant__ typename VnClass<C>::Prm prm) {
  const long long items = static_cast<long long>(n_rows) * Z * nchunks;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    int node, b;
    if (!item_frames<V>(item, nchunks, B, &node, &b)) continue;
    const int rr = node / Z;
    const int z = node - rr * Z;
    const int r = r_lo + rr;
    const QcRows in{src + r * maxd, shift + r * maxd, z, Z};
    const QcRows out{dst + r * maxd, nullptr, z, Z};
    vn_item<T, C, V>(m_cn, cha, m_vn, bits, unan, in, out,
                     static_cast<size_t>(node_base[r] + z), B, b, prm);
  }
}

// ---------------------------------------------------------------------------
// graphs without circulant structure: the num_nodes real node rows of class
// C, slot planes at edge_start with n_pad rows each, node rows from
// node_start
// ---------------------------------------------------------------------------
template <typename T, int C, int V>
__global__ void __launch_bounds__(kThreads)
vn_std_class_kernel(const T* __restrict__ m_in, const T* __restrict__ cha,
                    T* __restrict__ m_out, int8_t* __restrict__ bits,
                    uint8_t* __restrict__ unan, int node_start, int n_pad,
                    int num_nodes, int edge_start, int B,
                    int nchunks,
                    const __grid_constant__ typename VnClass<C>::Prm prm) {
  const long long items = static_cast<long long>(num_nodes) * nchunks;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    int off, b;
    if (!item_frames<V>(item, nchunks, B, &off, &b)) continue;
    const StdRows rows{edge_start, n_pad, off};
    vn_item<T, C, V>(m_in, cha, m_out, bits, unan, rows, rows,
                     static_cast<size_t>(node_start + off), B, b, prm);
  }
}

// ---------------------------------------------------------------------------
// the per-degree-block loop: the num_nodes real node rows of VN layout block
// C; inputs at rows[slot row] of the CN-grouped m_in (the gather folded into
// the loads), outputs at the slot rows of the VN-grouped m_out (edge_start,
// n_pad rows a plane), channel and bits at node rows from node_start
// ---------------------------------------------------------------------------
template <typename T, int C, int V>
__global__ void __launch_bounds__(kThreads)
vn_block_class_kernel(const T* __restrict__ m_in, const int* __restrict__ rows,
                      const T* __restrict__ cha, T* __restrict__ m_out,
                      int8_t* __restrict__ bits, uint8_t* __restrict__ unan,
                      int node_start, int n_pad, int num_nodes, int edge_start,
                      int B, int nchunks,
                      const __grid_constant__ typename VnClass<C>::Prm prm) {
  const long long items = static_cast<long long>(num_nodes) * nchunks;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    int off, b;
    if (!item_frames<V>(item, nchunks, B, &off, &b)) continue;
    const StdRows out{edge_start, n_pad, off};
    const GatherRows in{rows, out};
    vn_item<T, C, V>(m_in, cha, m_out, bits, unan, in, out,
                     static_cast<size_t>(node_start + off), B, b, prm);
  }
}

// Blocks of `kernel` the card holds at once.
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

template <typename K>
int launch(K kernel, int* resident, long long items, void** args,
           void* stream) {
  if (items <= 0) return kNothingToLaunch;
  if (*resident == 0) *resident = resident_blocks(kernel);
  if (*resident <= 0 || items >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = items < *resident ? items : *resident;
  cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                   dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

inline int chunks(int B, int V) {
  return (B + kThreads * V - 1) / (kThreads * V);
}

template <int C>
typename VnClass<C>::Prm class_params(const float* prm_row) {
  typename VnClass<C>::Prm prm;
  memcpy(prm.v, prm_row + VnClass<C>::OFF, VnClass<C>::LEN * sizeof(float));
  return prm;
}

template <typename T, int C, int V>
int launch_qc(const void* m_cn, const void* cha, void* m_vn, void* bits,
              void* unan, const void* src, const void* shift, const void* dst,
              const void* node_base, int r_lo, int n_rows, int Z, int maxd,
              int B, const float* prm_row, void* stream) {
  static int resident = 0;
  int nchunks = chunks(B, V);
  typename VnClass<C>::Prm prm = class_params<C>(prm_row);
  void* args[] = {&m_cn, &cha, &m_vn,  &bits, &unan, &src, &shift,   &dst,
                  &node_base, &r_lo, &n_rows, &Z, &maxd, &B, &nchunks, &prm};
  return launch(vn_qc_class_kernel<T, C, V>, &resident,
                static_cast<long long>(n_rows) * Z * nchunks, args, stream);
}

template <typename T, int C, int V>
int launch_std(const void* m_in, const void* cha, void* m_out, void* bits,
               void* unan, int node_start, int n_pad, int num_nodes,
               int edge_start, int B, const float* prm_row, void* stream) {
  static int resident = 0;
  int nchunks = chunks(B, V);
  typename VnClass<C>::Prm prm = class_params<C>(prm_row);
  void* args[] = {&m_in,      &cha,   &m_out,     &bits,       &unan, &node_start,
                  &n_pad, &num_nodes, &edge_start, &B, &nchunks, &prm};
  return launch(vn_std_class_kernel<T, C, V>, &resident,
                static_cast<long long>(num_nodes) * nchunks, args, stream);
}

template <typename T, int C, int V>
int launch_block(const void* m_in, const void* rows, const void* cha,
                 void* m_out, void* bits, void* unan, int node_start, int n_pad,
                 int num_nodes, int edge_start, int B, const float* prm_row,
                 void* stream) {
  static int resident = 0;
  int nchunks = chunks(B, V);
  typename VnClass<C>::Prm prm = class_params<C>(prm_row);
  void* args[] = {&m_in,       &rows,      &cha,        &m_out, &bits,
                  &unan,       &node_start, &n_pad,     &num_nodes,
                  &edge_start, &B,         &nchunks,    &prm};
  return launch(vn_block_class_kernel<T, C, V>, &resident,
                static_cast<long long>(num_nodes) * nchunks, args, stream);
}

// V frames a thread where the batch width and the arrays allow it
template <int C>
constexpr int class_vec() {
  return vec_width(VnClass<C>::D);
}
template <int C>
bool use_vec(int B, int aligned) {
  return class_vec<C>() > 1 && aligned && B % class_vec<C>() == 0;
}

}  // namespace lutvn

extern "C" {

// Frames a thread of class `cls` for a batch of B frames (aligned: every
// array starts on a 16-byte boundary); -1 for an unknown class.
int lut_vn_vec(int cls, int B, int aligned) {
  switch (cls) {
#define LUT_VN_CASE(C) \
  case C:              \
    return lutvn::use_vec<C>(B, aligned) ? lutvn::class_vec<C>() : 1;
    LUT_VN_FOR_CLASSES(LUT_VN_CASE)
#undef LUT_VN_CASE
  }
  return -1;
}

#ifdef LUT_VN_QC
// One run of block-rows of class `cls`; prm_row: the iteration's parameter
// row in host memory.
int lut_vn_qc_class(int cls, const void* m_cn, const void* cha, void* m_vn,
                    void* bits, void* unan, const void* src, const void* shift,
                    const void* dst, const void* node_base, int r_lo,
                    int n_rows, int Z, int maxd, int B, int aligned,
                    const float* prm_row, void* stream) {
  switch (cls) {
#define LUT_VN_CASE(C)                                                        \
  case C:                                                                     \
    return lutvn::use_vec<C>(B, aligned)                                      \
               ? lutvn::launch_qc<LutVnT, C, lutvn::class_vec<C>()>(          \
                     m_cn, cha, m_vn, bits, unan, src, shift, dst, node_base, \
                     r_lo, n_rows, Z, maxd, B, prm_row, stream)               \
               : lutvn::launch_qc<LutVnT, C, 1>(                              \
                     m_cn, cha, m_vn, bits, unan, src, shift, dst, node_base, \
                     r_lo, n_rows, Z, maxd, B, prm_row, stream);
    LUT_VN_FOR_CLASSES(LUT_VN_CASE)
#undef LUT_VN_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // LUT_VN_QC

#ifdef LUT_VN_STD
// The real node rows of class `cls`.
int lut_vn_std_class(int cls, const void* m_in, const void* cha, void* m_out,
                     void* bits, void* unan, int node_start, int n_pad,
                     int num_nodes, int edge_start, int B, int aligned,
                     const float* prm_row, void* stream) {
  switch (cls) {
#define LUT_VN_CASE(C)                                                     \
  case C:                                                                  \
    return lutvn::use_vec<C>(B, aligned)                                   \
               ? lutvn::launch_std<LutVnT, C, lutvn::class_vec<C>()>(      \
                     m_in, cha, m_out, bits, unan, node_start, n_pad,      \
                     num_nodes, edge_start, B, prm_row, stream)            \
               : lutvn::launch_std<LutVnT, C, 1>(                          \
                     m_in, cha, m_out, bits, unan, node_start, n_pad,      \
                     num_nodes, edge_start, B, prm_row, stream);
    LUT_VN_FOR_CLASSES(LUT_VN_CASE)
#undef LUT_VN_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // LUT_VN_STD

#ifdef LUT_VN_BLOCK
// The real node rows of VN layout block `cls`; rows: the input row of every
// slot row, or null for the slot rows themselves.
int lut_vn_block_class(int cls, const void* m_in, const void* rows,
                       const void* cha, void* m_out, void* bits, void* unan,
                       int node_start, int n_pad, int num_nodes, int edge_start,
                       int B, int aligned, const float* prm_row, void* stream) {
  switch (cls) {
#define LUT_VN_CASE(C)                                                      \
  case C:                                                                   \
    return lutvn::use_vec<C>(B, aligned)                                    \
               ? lutvn::launch_block<LutVnT, C, lutvn::class_vec<C>()>(     \
                     m_in, rows, cha, m_out, bits, unan, node_start, n_pad, \
                     num_nodes, edge_start, B, prm_row, stream)             \
               : lutvn::launch_block<LutVnT, C, 1>(                         \
                     m_in, rows, cha, m_out, bits, unan, node_start, n_pad, \
                     num_nodes, edge_start, B, prm_row, stream);
    LUT_VN_FOR_CLASSES(LUT_VN_CASE)
#undef LUT_VN_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // LUT_VN_BLOCK

}  // extern "C"
