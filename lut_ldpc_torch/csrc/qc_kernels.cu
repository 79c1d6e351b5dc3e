// CN and VN passes of the value-domain LUT decode for Hopper (sm_90a).
//
// Six kernels sharing their arithmetic, two per graph family:
//   cn_qc_kernel / vn_qc_kernel   replace lut_ldpc_tpu/decoder/qc_kernels.py
//     ::cn_qc_pass (Pallas body _cn_qc_kernel) and ::vn_qc_pass
//     (_vn_qc_kernel) for quasi-cyclic graphs: a circulant shift is a
//     modular row index in the load;
//   cn_std_kernel / vn_std_kernel replace ::cn_std_pass (_cn_std_kernel) and
//     ::vn_std_pass (_vn_std_kernel) for graphs without circulant structure:
//     each degree class is a run of contiguous slot planes, the permutation
//     between the VN- and CN-grouped orders is a row gather outside the
//     kernel, and padding rows of a class are skipped (never read into the
//     syndrome or unanimity flags, never written);
//   cn_block_kernel replaces lut_ldpc_tpu/decoder/pallas_kernels.py::cn_pass
//     (_cn_kernel), and vn_block_kernel, the table-driven witness of the
//     generated vn_block_class_kernel, computes ::vn_pass (_vn_kernel): one
//     degree block, (d, n_pad, B) slot planes,
//     the VN tree evaluated in full for every leave-one-out output through
//     the caller's index table (no shared sweeps), every op a plain select
//     chain with a tie at a zero sum.  Bound: bytes, as the others; the full
//     evaluation costs d times the tree per node, which a block of low
//     degree hides behind its loads and a block of high degree does not.
// The decoders' CN passes run in the frames of cn_frames.cuh (libraries of
// their own); cn_qc_kernel and cn_std_kernel here are their table-driven
// witness, as vn_qc_kernel, vn_std_kernel and vn_block_kernel are for the
// generated VN kernels of vn_frames.cuh.
// What the Pallas kernels compute (_vn_class_compute, the two-min CN) is
// kept; the TPU schedule (halo planes, 8-row realign, per-class tile
// lengths, double-buffered window DMAs, SMEM step tables) is not.  Messages
// stay in the standard slot-major grouped layout, (rows, B) with the frame
// axis B contiguous.
//
// Bound: bytes.  Each pass streams int16 (or f32) messages once in and once
// out and does little arithmetic per byte.  The VN pass over high-degree
// classes (d leave-one-out outputs of a d-1 op tree) stays below the bytes
// time only because the two shared sweeps of vn_update cut the op
// evaluations from d(d-1) to about 2(d-1) + d log2(d) (96 for 272 at
// d=17); ascending thresholds are bisected.  One thread owns one (node,
// frame) pair; threads of a warp take consecutive frames, so every load
// and store is a coalesced row segment.  Per-iteration VN parameters are staged in shared memory
// once per thread block; the tree itself is read from small int tables, so
// one binary serves every codec.
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
constexpr int kMaxOps = 32;   // ops of one VN tree
constexpr int kOpCols = 7;    // ints per op in op_info
constexpr int kClsCols = 5;   // node_start, n_pad, num_nodes, degree, edge_start

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

// Class of padded node row g in a (C, kClsCols) class table; returns false
// for a padding row.  Sets the class index and the node's slot rows.
__device__ __forceinline__ bool std_node(const int* __restrict__ cls, int ncls,
                                         int g, int* c_out, int* d_out,
                                         StdRows* rows) {
  int c = 0;
  while (c + 1 < ncls && g >= cls[(c + 1) * kClsCols]) ++c;
  const int* e = cls + c * kClsCols;
  const int off = g - e[0];
  *c_out = c;
  *d_out = e[3];
  rows->edge_start = e[4];
  rows->n_pad = e[1];
  rows->off = off;
  return off < e[2];
}

// CN update of one check for one frame: running min1/min2 and sign parity
// over the d inputs, out_k = (|x_k| == min1 ? min2 : min1) signed by
// parity ^ sign(x_k).  Returns the parity of the input signs.
template <typename T, int MAXD, typename Src, typename Dst>
__device__ __forceinline__ bool cn_update(const T* __restrict__ m_in,
                                          T* __restrict__ m_out, int d,
                                          const Src& src, const Dst& dst,
                                          int B, int b) {
  float x[MAXD];
  float min1 = INFINITY, min2 = INFINITY;
  bool par = false;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k < d) {
      const float v =
          static_cast<float>(m_in[static_cast<size_t>(src(k)) * B + b]);
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
      m_out[static_cast<size_t>(dst(k)) * B + b] =
          to_store<T>(flip ? -tmp : tmp);
    }
  }
  return par;
}

// One degree class's threshold tree: ops [op0, op0 + nops) of op_info
// (kOpCols ints per op: operand start, operand count, nthr, flags,
// parameter offset, lo and hi of the message-leaf positions under the op),
// operands in opnds, this iteration's parameters in sprm (shared memory).
struct VnTree {
  int d, op0, nops;
  const int* op_info;
  const int* opnds;
  const float* sprm;
};

__device__ __forceinline__ void stage_params(float* sprm,
                                             const float* __restrict__ prm,
                                             int it, int prm_row) {
  for (int i = threadIdx.x; i < prm_row; i += kThreads)
    sprm[i] = prm[static_cast<size_t>(it) * prm_row + i];
  __syncthreads();
}

// The emission of op o for the operand sum s: the select chain
// out = lev[0]; out = lev[t+1] where x >= thr[t] (flag 4: the thresholds
// ascend, so the chain's result is found by bisection); sym ops (flag 1)
// chain on |s| and restore the sign; tie ops (flag 2) emit tie_lo/tie_hi at
// s == 0 by the sign of `last`, the value of the op's last operand.
__device__ __forceinline__ float emit_op(const VnTree& t, int o, float s,
                                         float last) {
  const int* oi = t.op_info + (t.op0 + o) * kOpCols;
  const int nthr = oi[2], fl = oi[3];
  const float* thr = t.sprm + oi[4];
  const float* lev = thr + nthr;
  const float x = (fl & 1) ? fabsf(s) : s;
  float out;
  if (fl & 4) {
    // ascending thresholds: the chain ends on lev[thresholds reached]
    int lo = 0, hi = nthr;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (x >= thr[mid]) lo = mid + 1; else hi = mid;
    }
    out = lev[lo];
  } else {
    out = lev[0];
    for (int j = 0; j < nthr; ++j) {
      if (x >= thr[j]) out = lev[j + 1];
    }
  }
  if (fl & 1) out = (s < 0.f) ? -out : out;
  if ((fl & 2) && s == 0.f) out = (last < 0.f) ? lev[nthr + 1] : lev[nthr + 2];
  return out;
}

// One op: the sum of its operands left to right, then its emission.
// val(x) gives the value in operand slot x.
template <typename Val>
__device__ __forceinline__ float eval_op(const VnTree& t, int o,
                                         const Val& val) {
  const int* oi = t.op_info + (t.op0 + o) * kOpCols;
  const int os = oi[0], oc = oi[1];
  float last = val(t.opnds[os]);
  float s = last;
  for (int q = 1; q < oc; ++q) {
    last = val(t.opnds[os + q]);
    s = s + last;
  }
  return emit_op(t, o, s, last);
}

// VN update of one variable for one frame: for each output edge i, the
// class's threshold tree evaluated on the leave-one-out leaves (position j
// of the d-1 message leaves takes message j for j < i and message j+1
// otherwise; the channel is the last leaf).  A sub-tree whose message
// positions all lie below i has the value it takes under the identity
// assignment, one whose positions all lie at or above i the value under
// the shift-by-one assignment: two bottom-up sweeps give those, and per
// output only the ops that straddle i are evaluated again (the shared
// sweeps of _vn_class_compute; values are identical op for op).  Sets
// *neg0 to the sign of output 0 and returns whether all output signs agree.
template <typename T, int MAXD, typename Src, typename Dst>
__device__ __forceinline__ bool vn_update(const T* __restrict__ m_in,
                                          T* __restrict__ m_out, float ch,
                                          const VnTree& t, const Src& src,
                                          const Dst& dst, int B, int b,
                                          bool* neg0_out) {
  const int d = t.d, nops = t.nops;
  float msg[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k < d)
      msg[k] = static_cast<float>(m_in[static_cast<size_t>(src(k)) * B + b]);
  }
  float idv[kMaxOps], s1v[kMaxOps], cur[kMaxOps];
  for (int shift = 0; shift < 2; ++shift) {
    float* arr = shift ? s1v : idv;
    const auto val = [&](int x) {
      return x < d - 1 ? msg[x + shift] : (x == d - 1 ? ch : arr[x - d]);
    };
    for (int o = 0; o < nops; ++o) arr[o] = eval_op(t, o, val);
  }
  const int* span = t.op_info + t.op0 * kOpCols + 5;  // (lo, hi) of op 0
  bool neg0 = false, agree = true;
  for (int i = 0; i < d; ++i) {
    float o_i;
    if (nops == 0) {
      o_i = ch;  // degree 1: the channel value alone
    } else if (i == d - 1) {
      o_i = idv[nops - 1];
    } else if (i == 0) {
      o_i = s1v[nops - 1];
    } else {
      const auto val = [&](int x) {
        if (x < d - 1) return msg[x < i ? x : x + 1];
        if (x == d - 1) return ch;
        const int k = x - d;
        const int lo = span[k * kOpCols], hi = span[k * kOpCols + 1];
        if (lo < 0 || hi < i) return idv[k];
        return lo >= i ? s1v[k] : cur[k];
      };
      for (int o = 0; o < nops; ++o) {
        const int lo = span[o * kOpCols], hi = span[o * kOpCols + 1];
        if (lo >= 0 && lo < i && hi >= i) cur[o] = eval_op(t, o, val);
      }
      o_i = val(d + nops - 1);
    }
    m_out[static_cast<size_t>(dst(i)) * B + b] = to_store<T>(o_i);
    const bool ni = o_i < 0.f;
    if (i == 0)
      neg0 = ni;
    else
      agree = agree && (ni == neg0);
  }
  *neg0_out = neg0;
  return agree;
}

// ---------------------------------------------------------------------------
// quasi-cyclic graphs: one thread per (block-row, z, frame)
// ---------------------------------------------------------------------------
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
  const QcRows in{src + r * maxd, shift + r * maxd, z, Z};
  const QcRows out{dst + r * maxd, nullptr, z, Z};
  // the syndrome flag is cleared where the input parity is odd
  if (cn_update<T, MAXD>(m_vn, m_cn, deg[r], in, out, B, b)) synd[b] = 0;
}

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
  stage_params(sprm, prm, it, prm_row);

  const int node = blockIdx.x / nbx;
  const int b = (blockIdx.x - node * nbx) * kThreads + threadIdx.x;
  if (b >= B) return;
  const int r = node / Z;
  const int z = node - r * Z;
  const int c = row_cls[r];
  const VnTree tree{cls_deg[c], cls_op0[c], cls_nops[c], op_info, opnds, sprm};
  const QcRows in{src + r * maxd, shift + r * maxd, z, Z};
  const QcRows out{dst + r * maxd, nullptr, z, Z};
  const size_t nrow = static_cast<size_t>(node_base[r] + z) * B + b;
  bool neg0;
  const bool agree = vn_update<T, MAXD>(
      m_cn, m_vn, static_cast<float>(cha[nrow]), tree, in, out, B, b, &neg0);
  bits[nrow] = neg0 ? 1 : 0;
  if (!agree) unan[b] = 0;
}

// ---------------------------------------------------------------------------
// graphs without circulant structure: one thread per (padded node row, frame)
// ---------------------------------------------------------------------------
template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
cn_std_kernel(const T* __restrict__ m_in, T* __restrict__ m_out,
              uint8_t* __restrict__ synd, const int* __restrict__ cls,
              int ncls, int B, int nbx) {
  const int g = blockIdx.x / nbx;
  const int b = (blockIdx.x - g * nbx) * kThreads + threadIdx.x;
  if (b >= B) return;
  int c, d;
  StdRows rows;
  if (!std_node(cls, ncls, g, &c, &d, &rows)) return;  // padding row
  if (cn_update<T, MAXD>(m_in, m_out, d, rows, rows, B, b)) synd[b] = 0;
}

template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
vn_std_kernel(const T* __restrict__ m_in, const T* __restrict__ cha,
              T* __restrict__ m_out, int8_t* __restrict__ bits,
              uint8_t* __restrict__ unan, const int* __restrict__ cls,
              int ncls, const int* __restrict__ cls_op0,
              const int* __restrict__ cls_nops,
              const int* __restrict__ op_info, const int* __restrict__ opnds,
              const float* __restrict__ prm, int it, int prm_row, int B,
              int nbx) {
  extern __shared__ float sprm[];
  stage_params(sprm, prm, it, prm_row);

  const int g = blockIdx.x / nbx;
  const int b = (blockIdx.x - g * nbx) * kThreads + threadIdx.x;
  if (b >= B) return;
  int c, d;
  StdRows rows;
  if (!std_node(cls, ncls, g, &c, &d, &rows)) return;  // padding row
  const VnTree tree{d, cls_op0[c], cls_nops[c], op_info, opnds, sprm};
  const size_t nrow = static_cast<size_t>(g) * B + b;  // node_start + off == g
  bool neg0;
  const bool agree = vn_update<T, MAXD>(
      m_in, m_out, static_cast<float>(cha[nrow]), tree, rows, rows, B, b,
      &neg0);
  bits[nrow] = neg0 ? 1 : 0;
  if (!agree) unan[b] = 0;
}

// ---------------------------------------------------------------------------
// one degree block, (d, n_pad, B) slot planes: one thread per (node row, frame)
// ---------------------------------------------------------------------------
template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
cn_block_kernel(const T* __restrict__ m_in, T* __restrict__ m_out,
                uint8_t* __restrict__ synd, int d, int n_pad, int n_real,
                int B, int nbx) {
  const int g = blockIdx.x / nbx;
  const int b = (blockIdx.x - g * nbx) * kThreads + threadIdx.x;
  if (b >= B || g >= n_real) return;  // padding row
  const StdRows rows{0, n_pad, g};
  if (cn_update<T, MAXD>(m_in, m_out, d, rows, rows, B, b)) synd[b] = 0;
}

// Every leave-one-out output i evaluates the whole tree: message leaf x
// takes message loo[i * d + x], the channel is leaf d - 1; with use_tot
// the sum of op 0 is (m_0 + ... + m_{d-1}) - m_i.
template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
vn_block_kernel(const T* __restrict__ m_in, const T* __restrict__ cha,
                T* __restrict__ m_out, uint8_t* __restrict__ bits,
                uint8_t* __restrict__ unan, const int* __restrict__ op_info,
                const int* __restrict__ opnds, const int* __restrict__ loo,
                const float* __restrict__ prm, int it, int prm_row, int d,
                int nops, int use_tot, int n_pad, int n_real, int B, int nbx) {
  extern __shared__ float sprm[];
  stage_params(sprm, prm, it, prm_row);

  const int g = blockIdx.x / nbx;
  const int b = (blockIdx.x - g * nbx) * kThreads + threadIdx.x;
  if (b >= B || g >= n_real) return;  // padding row
  const StdRows rows{0, n_pad, g};
  float msg[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k < d)
      msg[k] = static_cast<float>(m_in[static_cast<size_t>(rows(k)) * B + b]);
  }
  const size_t nrow = static_cast<size_t>(g) * B + b;
  const float ch = static_cast<float>(cha[nrow]);
  float tot = 0.f;
  if (use_tot) {
    tot = msg[0];
    for (int k = 1; k < d; ++k) tot = tot + msg[k];
  }
  const VnTree tree{d, 0, nops, op_info, opnds, sprm};
  float cur[kMaxOps];
  bool neg0 = false, agree = true;
  for (int i = 0; i < d; ++i) {
    const int* li = loo + i * d;
    const auto val = [&](int x) {
      return x < d - 1 ? msg[li[x]] : (x == d - 1 ? ch : cur[x - d]);
    };
    for (int o = 0; o < nops; ++o) {
      if (o == 0 && use_tot) {
        const int* oi = op_info;  // op 0: operand start, operand count
        cur[0] = emit_op(tree, 0, tot - msg[i], val(opnds[oi[0] + oi[1] - 1]));
      } else {
        cur[o] = eval_op(tree, o, val);
      }
    }
    const float o_i = nops ? cur[nops - 1] : ch;
    m_out[static_cast<size_t>(rows(i)) * B + b] = to_store<T>(o_i);
    const bool ni = o_i < 0.f;
    if (i == 0)
      neg0 = ni;
    else
      agree = agree && (ni == neg0);
  }
  bits[nrow] = neg0 ? 1 : 0;
  if (!agree) unan[b] = 0;
}

inline int blocks_x(int B) { return (B + kThreads - 1) / kThreads; }

template <typename T, int MAXD>
int launch_cn_block(const void* m_in, void* m_out, void* synd, int d,
                    int n_pad, int n_real, int B, void* stream) {
  const int nbx = blocks_x(B);
  cn_block_kernel<T, MAXD><<<static_cast<unsigned>(n_pad) * nbx, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(m_in), static_cast<T*>(m_out),
      static_cast<uint8_t*>(synd), d, n_pad, n_real, B, nbx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MAXD>
int launch_vn_block(const void* m_in, const void* cha, void* m_out, void* bits,
                    void* unan, const void* op_info, const void* opnds,
                    const void* loo, const void* prm, int it, int prm_row,
                    int d, int nops, int use_tot, int n_pad, int n_real, int B,
                    void* stream) {
  const int nbx = blocks_x(B);
  const size_t smem = static_cast<size_t>(prm_row) * sizeof(float);
  vn_block_kernel<T, MAXD><<<static_cast<unsigned>(n_pad) * nbx, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(m_in), static_cast<const T*>(cha),
      static_cast<T*>(m_out), static_cast<uint8_t*>(bits),
      static_cast<uint8_t*>(unan), static_cast<const int*>(op_info),
      static_cast<const int*>(opnds), static_cast<const int*>(loo),
      static_cast<const float*>(prm), it, prm_row, d, nops, use_tot, n_pad,
      n_real, B, nbx);
  return static_cast<int>(cudaGetLastError());
}

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

template <typename T, int MAXD>
int launch_cn_std(const void* m_in, void* m_out, void* synd, const void* cls,
                  int ncls, int nodes, int B, void* stream) {
  const int nbx = blocks_x(B);
  cn_std_kernel<T, MAXD><<<static_cast<unsigned>(nodes) * nbx, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(m_in), static_cast<T*>(m_out),
      static_cast<uint8_t*>(synd), static_cast<const int*>(cls), ncls, B, nbx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MAXD>
int launch_vn_std(const void* m_in, const void* cha, void* m_out, void* bits,
                  void* unan, const void* cls, int ncls, const void* cls_op0,
                  const void* cls_nops, const void* op_info, const void* opnds,
                  const void* prm, int it, int prm_row, int nodes, int B,
                  void* stream) {
  const int nbx = blocks_x(B);
  const size_t smem = static_cast<size_t>(prm_row) * sizeof(float);
  vn_std_kernel<T, MAXD><<<static_cast<unsigned>(nodes) * nbx, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(m_in), static_cast<const T*>(cha),
      static_cast<T*>(m_out), static_cast<int8_t*>(bits),
      static_cast<uint8_t*>(unan), static_cast<const int*>(cls), ncls,
      static_cast<const int*>(cls_op0), static_cast<const int*>(cls_nops),
      static_cast<const int*>(op_info), static_cast<const int*>(opnds),
      static_cast<const float*>(prm), it, prm_row, B, nbx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// maxd (the row-table width, the largest degree) picks the instantiation.
#define LUT_DISPATCH(fn, ...)                                     \
  (is_f32 ? (maxd <= 8    ? fn<float, 8>(__VA_ARGS__)             \
             : maxd <= 16 ? fn<float, 16>(__VA_ARGS__)            \
                          : fn<float, 32>(__VA_ARGS__))           \
          : (maxd <= 8    ? fn<int16_t, 8>(__VA_ARGS__)           \
             : maxd <= 16 ? fn<int16_t, 16>(__VA_ARGS__)          \
                          : fn<int16_t, 32>(__VA_ARGS__)))

extern "C" {

int lut_cn_qc_pass(int is_f32, const void* m_vn, void* m_cn, void* synd,
                   const void* src, const void* shift, const void* dst,
                   const void* deg, int R, int Z, int maxd, int B,
                   void* stream) {
  if (maxd > 32) return static_cast<int>(cudaErrorInvalidValue);
  return LUT_DISPATCH(launch_cn, m_vn, m_cn, synd, src, shift, dst, deg, R, Z,
                      maxd, B, stream);
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
  return LUT_DISPATCH(launch_vn, m_cn, cha, m_vn, bits, unan, src, shift, dst,
                      node_base, row_cls, cls_deg, cls_op0, cls_nops, op_info,
                      opnds, prm, it, prm_row, R, Z, maxd, B, stream);
}

// Std layout: `nodes` padded node rows over `ncls` degree classes (cls: the
// (ncls, 5) class table).
int lut_cn_std_pass(int is_f32, const void* m_in, void* m_out, void* synd,
                    const void* cls, int ncls, int nodes, int maxd, int B,
                    void* stream) {
  if (maxd > 32) return static_cast<int>(cudaErrorInvalidValue);
  return LUT_DISPATCH(launch_cn_std, m_in, m_out, synd, cls, ncls, nodes, B,
                      stream);
}

int lut_vn_std_pass(int is_f32, const void* m_in, const void* cha, void* m_out,
                    void* bits, void* unan, const void* cls, int ncls,
                    const void* cls_op0, const void* cls_nops,
                    const void* op_info, const void* opnds, const void* prm,
                    int it, int prm_row, int nodes, int maxd, int B,
                    void* stream) {
  if (maxd > 32 || static_cast<size_t>(prm_row) * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  return LUT_DISPATCH(launch_vn_std, m_in, cha, m_out, bits, unan, cls, ncls,
                      cls_op0, cls_nops, op_info, opnds, prm, it, prm_row,
                      nodes, B, stream);
}

// One degree block: m (d, n_pad, B) slot planes, rows >= n_real are padding.
int lut_cn_block_pass(int is_f32, const void* m_in, void* m_out, void* synd,
                      int maxd, int n_pad, int n_real, int B, void* stream) {
  if (maxd > 32) return static_cast<int>(cudaErrorInvalidValue);
  return LUT_DISPATCH(launch_cn_block, m_in, m_out, synd, maxd, n_pad, n_real,
                      B, stream);
}

int lut_vn_block_pass(int is_f32, const void* m_in, const void* cha,
                      void* m_out, void* bits, void* unan, const void* op_info,
                      const void* opnds, const void* loo, const void* prm,
                      int it, int prm_row, int maxd, int nops, int use_tot,
                      int n_pad, int n_real, int B, void* stream) {
  if (maxd > 32 || nops > kMaxOps ||
      static_cast<size_t>(prm_row) * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  return LUT_DISPATCH(launch_vn_block, m_in, cha, m_out, bits, unan, op_info,
                      opnds, loo, prm, it, prm_row, maxd, nops, use_tot, n_pad,
                      n_real, B, stream);
}

}  // extern "C"
