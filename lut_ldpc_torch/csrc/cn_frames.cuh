// CN frames of the value-domain decode for Hopper (sm_90a); compiled through
// cn_frames.cu into one library per message storage type (LUT_CN_STORAGE:
// int16_t or float), each half of the instantiations, the two built side by
// side.
//
// Replace lut_ldpc_tpu/decoder/qc_kernels.py::cn_qc_pass (Pallas body
// _cn_qc_kernel) and ::cn_std_pass (_cn_std_kernel) with the arithmetic of
// cn_frame.h: the two-min update per check and frame, and a per-frame
// syndrome flag cleared where the input parity of a real check is odd.  The
// table-driven cn_qc_kernel / cn_std_kernel of qc_kernels.cu compute the same
// and stay as the witness (generic=True).
//
// Bound: bytes.  A pass reads every message once and writes it once and does
// about 13 float32 operations an edge, far below the card's rate.  What the
// design does about it:
//  - a thread owns V consecutive frames of one check (kVecBytes of a row:
//    8 int16 or 4 float32 frames) and issues all its d row loads, 16 bytes
//    each, before the arithmetic; threads of a warp take consecutive frame
//    groups, so every access is a 512-byte row segment;
//  - one instantiation per check degree (cn_frame.h), one launch per run of
//    block-rows (QC) or per degree class (std): x[] is d x V values in
//    registers, nothing is searched per thread;
//  - block (x, y) takes frame chunk x of check y: one check a block, as
//    many blocks as checks up to the grid's limit of 65535 rows, past which
//    a block walks the checks y, y + gridDim.y, ...; a thread ORs the parity
//    of its frames over its checks in a register and clears the syndrome
//    flags once at the end, looking first;
//  - std graphs: each check's slot rows come from the table `rows` (the
//    VN-grouped row of every CN-grouped edge row), so the kernel reads the
//    VN-grouped v2c array and writes the VN-grouped c2v array directly: the
//    two row gathers around the pass (jnp.take in the JAX loop) are folded
//    into its loads and stores.  Padding checks are never read, written or
//    counted in the syndrome; rows of padding variables are never written.
// Any batch width works: V frames a thread need B % V == 0 and 16-byte
// aligned message arrays; otherwise the one-frame instantiation runs.
//
// C entry points return cudaGetLastError() of the launch, or
// kNothingToLaunch where the launch would have no block: the caller counts a
// launch only where it saw 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cn_frame.h"

#ifndef LUT_CN_STORAGE
#error "build with -DLUT_CN_STORAGE=int16_t or -DLUT_CN_STORAGE=float"
#endif

namespace lutcn {

using Storage = LUT_CN_STORAGE;  // the message type this library serves

// Settled on an H100 80GB HBM3 at 700 W on builds of this file with other
// values (PERF.md, section 6): 8-byte accesses were no faster than 16
// (PEG int16 1.714 against 1.712 ms); a resident grid whose blocks walk
// their checks was slower than one check a block (PEG int16 1.712 against
// 1.702 ms, DVB-S2 f32 2.642 against 2.531, and at the odd width B - 3 up
// to 1.9 times slower: 5.669 against 2.966), 4 resident waves in between;
// clearing the flags after every check instead of once was 0-2 % slower.
constexpr int kThreads = 256;
constexpr int kVecBytes = 16;  // bytes of one row a thread loads
constexpr int kVecWidest = 16;  // widest instantiation with V > 1
constexpr int kMaxGridY = 65535;
constexpr int kNothingToLaunch = -1;  // no check or no frame: nothing launched

template <typename T>
constexpr int vec_frames() {
  return kVecBytes / static_cast<int>(sizeof(T));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// One check, frames [b, b + V): the d row loads, the frames one by one, the
// d row stores.  Bit f of the result: frame f's input parity is odd.
template <typename T, int W, int V>
__device__ __forceinline__ uint32_t cn_item(const T* __restrict__ m_in,
                                            T* __restrict__ m_out,
                                            const int (&src)[W],
                                            const int (&dst)[W], int d, int B,
                                            int b) {
  using VT = Vec<T, V>;
  VT v[W];
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k < d)
      v[k] = *reinterpret_cast<const VT*>(m_in + static_cast<size_t>(src[k]) * B + b);
  uint32_t par = 0;
#pragma unroll
  for (int f = 0; f < V; ++f) {
    float x[W];
#pragma unroll
    for (int k = 0; k < W; ++k) x[k] = k < d ? static_cast<float>(v[k].v[f]) : 0.f;
    if (cn_frame<W>(x, d)) par |= 1u << f;
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (k < d) v[k].v[f] = store_as<T>(x[k]);
  }
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k < d)
      *reinterpret_cast<VT*>(m_out + static_cast<size_t>(dst[k]) * B + b) = v[k];
  return par;
}

// Many threads clear the same flags: look first, store only a change, and
// never a 1.
template <int V>
__device__ __forceinline__ void clear_synd(uint8_t* __restrict__ synd, int b,
                                           uint32_t par) {
#pragma unroll
  for (int f = 0; f < V; ++f)
    if (((par >> f) & 1u) && synd[b + f] != 0) synd[b + f] = 0;
}

// ---------------------------------------------------------------------------
// quasi-cyclic graphs: block-rows [r_lo, r_lo + n_rows), all of degree d, Z
// checks each; m_cn[dst + z] = CN(m_vn[src + (z + shift) % Z]) per slot
// ---------------------------------------------------------------------------
template <typename T, int W, int V>
__global__ void __launch_bounds__(kThreads)
cn_qc_frames_kernel(const T* __restrict__ m_vn, T* __restrict__ m_cn,
                    uint8_t* __restrict__ synd, const int* __restrict__ src,
                    const int* __restrict__ shift, const int* __restrict__ dst,
                    int r_lo, int n_rows, int Z, int maxd, int d, int B) {
  const int b = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (b >= B) return;
  if (W <= kExact) d = W;
  const int nodes = n_rows * Z;
  uint32_t par = 0;
  for (int node = blockIdx.y; node < nodes; node += gridDim.y) {
    const int rr = node / Z;
    const int z = node - rr * Z;
    const int t = (r_lo + rr) * maxd;
    int in[W], out[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k < d) {
        int zz = z + shift[t + k];
        if (zz >= Z) zz -= Z;
        in[k] = src[t + k] + zz;
        out[k] = dst[t + k] + z;
      }
    }
    par |= cn_item<T, W, V>(m_vn, m_cn, in, out, d, B, b);
  }
  clear_synd<V>(synd, b, par);
}

// ---------------------------------------------------------------------------
// graphs without circulant structure: the num_nodes real checks of one degree
// class; slot k of check j sits at CN-grouped row e = edge_start + k * n_pad
// + j, and the check reads m_in and writes m_out at row rows[e] (the
// VN-grouped arrays through StdTables.inv_c2v)
// ---------------------------------------------------------------------------
template <typename T, int W, int V>
__global__ void __launch_bounds__(kThreads)
cn_std_frames_kernel(const T* __restrict__ m_in, T* __restrict__ m_out,
                     uint8_t* __restrict__ synd, const int* __restrict__ rows,
                     int n_pad, int num_nodes, int edge_start, int d, int B) {
  const int b = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (b >= B) return;
  if (W <= kExact) d = W;
  uint32_t par = 0;
  for (int j = blockIdx.y; j < num_nodes; j += gridDim.y) {
    int r[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k < d) r[k] = rows[edge_start + k * n_pad + j];
    }
    par |= cn_item<T, W, V>(m_in, m_out, r, r, d, B, b);
  }
  clear_synd<V>(synd, b, par);
}

// Grid (frame chunks, checks up to kMaxGridY) of kThreads-thread blocks.
template <typename K>
int launch(K kernel, long long nodes, int B, int V, void** args, void* stream) {
  const long long chunks = (static_cast<long long>(B) + kThreads * V - 1) / (kThreads * V);
  if (nodes <= 0 || chunks < 1) return kNothingToLaunch;
  if (chunks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = nodes < kMaxGridY ? nodes : kMaxGridY;
  cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                   dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(rows)),
                   dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W, int V>
int launch_qc(const void* m_vn, void* m_cn, void* synd, const void* src,
              const void* shift, const void* dst, int r_lo, int n_rows, int Z,
              int maxd, int d, int B, void* stream) {
  void* args[] = {&m_vn, &m_cn,   &synd, &src, &shift, &dst,
                  &r_lo, &n_rows, &Z,    &maxd, &d,    &B};
  return launch(cn_qc_frames_kernel<T, W, V>, static_cast<long long>(n_rows) * Z,
                B, V, args, stream);
}

template <typename T, int W, int V>
int launch_std(const void* m_in, void* m_out, void* synd, const void* rows,
               int n_pad, int num_nodes, int edge_start, int d, int B,
               void* stream) {
  void* args[] = {&m_in,      &m_out,      &synd, &rows, &n_pad,
                  &num_nodes, &edge_start, &d,    &B};
  return launch(cn_std_frames_kernel<T, W, V>, num_nodes, B, V, args, stream);
}

// V frames a thread where the batch width and the arrays allow it
template <typename T>
int frames_a_thread(int d, int B, int aligned) {
  constexpr int V = vec_frames<T>();
  return (aligned && width_of(d) <= kVecWidest && B % V == 0) ? V : 1;
}

template <typename T>
struct Tag {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// the library's storage type only: a call for the other one is refused
template <int W, typename F>
int with_width(int is_f32, int vec, F& f) {
  constexpr int V = W <= kVecWidest ? vec_frames<Storage>() : 1;
  if ((is_f32 != 0) != std::is_same<Storage, float>::value)
    return static_cast<int>(cudaErrorInvalidValue);
  return vec > 1 ? f(Tag<Storage>(), Int<W>(), Int<V>())
                 : f(Tag<Storage>(), Int<W>(), Int<1>());
}

// f(Tag<T>(), Int<W>(), Int<V>()) for the instantiation that serves
// (storage type, degree d, vec frames a thread)
template <typename F>
int dispatch(int is_f32, int d, int vec, F f) {
  switch (width_of(d)) {
#define LUT_CN_CASE(W) \
  case W:              \
    return with_width<W>(is_f32, vec, f);
    LUT_CN_FOR_WIDTHS(LUT_CN_CASE)
#undef LUT_CN_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace lutcn

extern "C" {

// Width of the instantiation that serves checks of degree d (d itself up to
// lutcn::kExact, then a bucket); 0 for none.
int lut_cn_width(int d) { return lutcn::width_of(d); }

// Frames a thread of the CN frames for checks of degree d at batch width B
// (aligned: the message arrays start on 16-byte boundaries); 0 for a degree
// without an instantiation.
int lut_cn_vec(int is_f32, int d, int B, int aligned) {
  if (lutcn::width_of(d) == 0) return 0;
  return is_f32 ? lutcn::frames_a_thread<float>(d, B, aligned)
                : lutcn::frames_a_thread<int16_t>(d, B, aligned);
}

// One run of block-rows [r_lo, r_lo + n_rows), all of check degree d.
int lut_cn_qc_frames(int is_f32, const void* m_vn, void* m_cn, void* synd,
                     const void* src, const void* shift, const void* dst,
                     int r_lo, int n_rows, int Z, int maxd, int d, int B,
                     int aligned, void* stream) {
  return lutcn::dispatch(
      is_f32, d, lut_cn_vec(is_f32, d, B, aligned), [&](auto t, auto w, auto v) {
        return lutcn::launch_qc<typename decltype(t)::type, decltype(w)::value,
                                decltype(v)::value>(
            m_vn, m_cn, synd, src, shift, dst, r_lo, n_rows, Z, maxd, d, B,
            stream);
      });
}

// One degree class of the std layout; rows: the VN-grouped row of every
// CN-grouped edge row (the folded gathers).
int lut_cn_std_frames(int is_f32, const void* m_in, void* m_out, void* synd,
                      const void* rows, int n_pad, int num_nodes,
                      int edge_start, int d, int B, int aligned, void* stream) {
  return lutcn::dispatch(
      is_f32, d, lut_cn_vec(is_f32, d, B, aligned), [&](auto t, auto w, auto v) {
        return lutcn::launch_std<typename decltype(t)::type, decltype(w)::value,
                                 decltype(v)::value>(
            m_in, m_out, synd, rows, n_pad, num_nodes, edge_start, d, B,
            stream);
      });
}

}  // extern "C"
