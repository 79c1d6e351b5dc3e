// Kernels of the value-domain loop's glue for Hopper (sm_90a): the
// early-exit state of one iteration, its latch, and the loop's initial
// values.
//
// They replace the torch glue that lut_ldpc_torch/decoder/arith_decoder.py
// ran around its CN and VN passes, the port of the JAX loop's own glue
// (lut_ldpc_tpu/decoder/arith_decoder.py:1253-1286: the label -> value
// selects before the loop, and per iteration conv = unan_p & synd & (it >= 1)
// & ~done, the latch, iters and done; :1046-1048 the same after the loop).
// The latch is a kernel of its own, not the VN kernels' epilogue: written
// there (a conv test and a masked copy after the stores) it took the
// generated degree-9 and degree-17 std classes from 69 and 80 registers to
// 145 and 255 with spills, and the PEG int16 VN pass at B=2048 from 2.557
// to 4.337 ms on an H100 80GB HBM3 at 700 W (PERF.md, section 6).
//
// Bound: bytes, and few of them, except init_values_kernel, which reads the
// two (B, nvar) label arrays once and writes the (nvar_pad, B) channel values
// and the (E_vn, B) edge values once.  What the torch ops cost was launches,
// passes over full-width arrays for a few frames' worth of change, int64
// copies and uncoalesced transposes.  What the design does about it:
//  - loop_state_kernel: one block, one thread a frame (a grid-stride loop),
//    everything of the early-exit state in one launch, the live count summed
//    in the block and written to one int (no atomics, no memset), which the
//    caller copies to pinned host memory without waiting;
//  - latch_kernel: one thread a frame column and a run of rows; a warp whose
//    frames have no conv leaves after one vote, so only the columns of the
//    frames that converged are touched;
//  - init_values_kernel: a 32 x 32 tile of (grouped node row, frame) through
//    shared memory, so the label reads run along the variable axis and the
//    value writes along the frame axis, both coalesced; int32 or int64 labels
//    as they come (no int64 copy); every edge row of the node written from
//    the same tile, phantom sockets pinned.
// C entry points return cudaGetLastError() of the launch, or
// kNothingToLaunch where the launch would have no block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace lutglue {

constexpr int kNothingToLaunch = -1;
constexpr int kStateThreads = 1024;
constexpr int kLatchThreads = 256;
constexpr int kLatchRows = 64;  // rows a latch thread copies at most
constexpr int kTile = 32;       // init tile: grouped rows x frames
constexpr int kTileRows = 8;    // threads along the tile's second axis
constexpr int kTabCols = 5;     // init table: var, e0, n_pad, degree, phantom mask

// conv = may_latch & unan_p & synd & ~done; iters = conv ? it : iters;
// done |= conv; *live = frames not done (where live is not null).
__global__ void __launch_bounds__(kStateThreads)
loop_state_kernel(const uint8_t* __restrict__ unan_p, const uint8_t* __restrict__ synd,
                  uint8_t* __restrict__ done, int32_t* __restrict__ iters,
                  uint8_t* __restrict__ conv, int32_t* __restrict__ live, int it,
                  int may_latch, int B) {
  int n = 0;
  for (int f = threadIdx.x; f < B; f += kStateThreads) {
    const bool d = done[f] != 0;
    const bool c = may_latch && !d && unan_p[f] != 0 && synd[f] != 0;
    conv[f] = c ? 1 : 0;
    if (c) {
      done[f] = 1;
      iters[f] = it;
    }
    n += (d || c) ? 0 : 1;
  }
  if (live == nullptr) return;
  __shared__ int part[kStateThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
  if (lane == 0) part[warp] = n;
  __syncthreads();
  if (warp == 0) {
    n = part[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
    if (lane == 0) *live = n;
  }
}

// latched[r, f] = prev[r, f] for every row r of the block's run where
// conv[f]; a warp without such a frame returns after its vote.
__global__ void __launch_bounds__(kLatchThreads)
latch_kernel(const uint8_t* __restrict__ conv, const int8_t* __restrict__ prev,
             int8_t* __restrict__ latched, int rows, int B) {
  const int f = blockIdx.x * kLatchThreads + threadIdx.x;
  const bool c = f < B && conv[f] != 0;
  if (!__any_sync(0xffffffffu, c) || !c) return;
  const int r0 = blockIdx.y * kLatchRows;
  const int r1 = min(rows, r0 + kLatchRows);
  for (int r = r0; r < r1; ++r) {
    const size_t at = static_cast<size_t>(r) * B + f;
    latched[at] = prev[at];
  }
}

// A label as an index into a table of nq entries, negative labels counted
// from the end (torch indexing); a label outside traps, as torch's device
// assert does.
template <typename L>
__device__ __forceinline__ int table_index(L label, int nq) {
  long long x = static_cast<long long>(label);
  if (x < 0) x += nq;
  if (x < 0 || x >= nq) __trap();
  return static_cast<int>(x);
}

// vcha[g, f] = leaf_cha[cha[f, var(g)]] for every grouped node row g; where
// m_vn is not null also, for every slot k of g's degree, m_vn[e0(g) + k *
// n_pad(g), f] = leaf_msg[msg[f, var(g)]], or pin where bit k of g's phantom
// mask is set.
template <typename T, typename L>
__global__ void __launch_bounds__(kTile * kTileRows)
init_values_kernel(const L* __restrict__ cha, const L* __restrict__ msg,
                   const int32_t* __restrict__ tab, const T* __restrict__ leaf_cha,
                   int nq_cha, const T* __restrict__ leaf_msg, int nq_msg,
                   T* __restrict__ vcha, T* __restrict__ m_vn, float pin, int G,
                   int nvar, int B) {
  __shared__ T tc[kTile][kTile + 1];
  __shared__ T tm[kTile][kTile + 1];
  const int g0 = blockIdx.x * kTile, f0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // labels: a warp reads 32 grouped rows (consecutive variables) of a frame
  if (g0 + tx < G) {
    const size_t var = static_cast<size_t>(tab[(g0 + tx) * kTabCols]);
#pragma unroll
    for (int j = ty; j < kTile; j += kTileRows) {
      const int f = f0 + j;
      if (f >= B) break;
      const size_t at = static_cast<size_t>(f) * nvar + var;
      tc[j][tx] = leaf_cha[table_index(cha[at], nq_cha)];
      if (m_vn != nullptr) tm[j][tx] = leaf_msg[table_index(msg[at], nq_msg)];
    }
  }
  __syncthreads();
  // values: a warp writes 32 frames of a row
  const int f = f0 + tx;
  if (f >= B) return;
  const T pinned = static_cast<T>(pin);
#pragma unroll
  for (int j = ty; j < kTile; j += kTileRows) {
    const int g = g0 + j;
    if (g >= G) break;
    vcha[static_cast<size_t>(g) * B + f] = tc[tx][j];
    if (m_vn == nullptr) continue;
    const int32_t* row = tab + g * kTabCols;
    const int e0 = row[1], n_pad = row[2], d = row[3];
    const uint32_t ph = static_cast<uint32_t>(row[4]);
    const T v = tm[tx][j];
    for (int k = 0; k < d; ++k)
      m_vn[static_cast<size_t>(e0 + k * n_pad) * B + f] = ((ph >> k) & 1u) ? pinned : v;
  }
}

template <typename T, typename L>
int launch_init(const void* cha, const void* msg, const void* tab, const void* leaf_cha,
                int nq_cha, const void* leaf_msg, int nq_msg, void* vcha, void* m_vn,
                float pin, int G, int nvar, int B, cudaStream_t stream) {
  const dim3 grid((G + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  init_values_kernel<T, L><<<grid, dim3(kTile, kTileRows), 0, stream>>>(
      static_cast<const L*>(cha), static_cast<const L*>(msg),
      static_cast<const int32_t*>(tab), static_cast<const T*>(leaf_cha), nq_cha,
      static_cast<const T*>(leaf_msg), nq_msg, static_cast<T*>(vcha),
      static_cast<T*>(m_vn), pin, G, nvar, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lutglue

extern "C" {

// The early-exit state of iteration `it` after its CN pass (may_latch: it
// >= 1); live: one int32 on the card for the count of frames not done, or
// null.
int lut_loop_state(const void* unan_p, const void* synd, void* done, void* iters,
                   void* conv, void* live, int it, int may_latch, int B, void* stream) {
  if (B <= 0) return lutglue::kNothingToLaunch;
  lutglue::loop_state_kernel<<<1, lutglue::kStateThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(unan_p), static_cast<const uint8_t*>(synd),
      static_cast<uint8_t*>(done), static_cast<int32_t*>(iters),
      static_cast<uint8_t*>(conv), static_cast<int32_t*>(live), it, may_latch, B);
  return static_cast<int>(cudaGetLastError());
}

// latched[:, f] = prev[:, f] for the frames f with conv[f], over `rows` rows.
int lut_latch(const void* conv, const void* prev, void* latched, int rows, int B,
              void* stream) {
  if (rows <= 0 || B <= 0) return lutglue::kNothingToLaunch;
  const dim3 grid((B + lutglue::kLatchThreads - 1) / lutglue::kLatchThreads,
                  (rows + lutglue::kLatchRows - 1) / lutglue::kLatchRows);
  lutglue::latch_kernel<<<grid, lutglue::kLatchThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(conv), static_cast<const int8_t*>(prev),
      static_cast<int8_t*>(latched), rows, B);
  return static_cast<int>(cudaGetLastError());
}

// The loop's initial values: is_f32 selects float32 over int16 values,
// label64 int64 over int32 labels; msg and m_vn null for the channel values
// alone.
int lut_init_values(int is_f32, int label64, const void* cha, const void* msg,
                    const void* tab, const void* leaf_cha, int nq_cha,
                    const void* leaf_msg, int nq_msg, void* vcha, void* m_vn, float pin,
                    int G, int nvar, int B, void* stream) {
  if (G <= 0 || B <= 0) return lutglue::kNothingToLaunch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return label64 ? lutglue::launch_init<float, int64_t>(cha, msg, tab, leaf_cha, nq_cha,
                                                         leaf_msg, nq_msg, vcha, m_vn, pin,
                                                         G, nvar, B, s)
                   : lutglue::launch_init<float, int32_t>(cha, msg, tab, leaf_cha, nq_cha,
                                                         leaf_msg, nq_msg, vcha, m_vn, pin,
                                                         G, nvar, B, s);
  return label64 ? lutglue::launch_init<int16_t, int64_t>(cha, msg, tab, leaf_cha, nq_cha,
                                                         leaf_msg, nq_msg, vcha, m_vn, pin,
                                                         G, nvar, B, s)
                 : lutglue::launch_init<int16_t, int32_t>(cha, msg, tab, leaf_cha, nq_cha,
                                                         leaf_msg, nq_msg, vcha, m_vn, pin,
                                                         G, nvar, B, s);
}

}  // extern "C"
