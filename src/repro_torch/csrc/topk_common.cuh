// The two-pass top-k of the fp16, int8 and pq slab_topk modes (K3, K4;
// slab_topk.cu), and the keys, total order and warp_best that the one-launch
// fp32 path (topk_tiled.cuh: ivf_topk and fp32 slab_topk) shares with it.
// Each entry point is a thin extern "C" function over launch(scorer).
//
// Two passes:
//   1. score + select: one block per (row chunk, query).  The block copies
//      its query operand (the query row, or its PQ lookup tables) into
//      shared memory, scores its chunk's rows with the scorer, and keeps the
//      chunk's best k candidates.  Every (query, row) score is a fixed-order
//      fp32 computation that does not depend on Q, N or where the row falls
//      in a chunk.
//   2. merge: one block per query selects the best k of all chunks' lists.
// Selection is under one TOTAL order -- score desc, then tie key asc, then
// row asc -- so the top k of the union of per-chunk top-k lists is the
// global top k, and a batch gives bitwise the result of its queries run one
// at a time.
//
// Scorers:
//   Dense<T, kScaled>  a warp per row: lane-strided FMAs of the row, widened
//                      from T (__half or int8_t) to f32 in registers, with
//                      the query, then a fixed xor butterfly; kScaled
//                      multiplies the finished score by the row's f32 scale
//                      (int8), as the TPU kernel scales its score tile.
//   PQ                 a thread per row: acc = 0, then acc += lut[j][code_j]
//                      for j ascending -- gathers and adds, no FMA, in the
//                      plain version's order, so PQ scores are bitwise equal
//                      to it on any input.
//
// Row r competes for query q only when virt[q, r] < kNotProbed; the tie key
// is virt[q, r], and non-members score kNegInf with key kNotProbed without
// being read.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace topk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;        // rows per scoring block
constexpr float kNegInf = -1e30f;  // score of a masked row
constexpr unsigned kFull = 0xffffffffu;

struct Key {
  float s;  // score
  int t;    // tie key (row index for ivf_topk, virt for slab_topk)
  int r;    // row index
};

// true iff a comes strictly before b in (score desc, t asc, r asc);
// +0.0 and -0.0 compare equal, so they fall through to the tie key
__device__ __forceinline__ bool before(const Key& a, const Key& b) {
  if (a.s > b.s) return true;
  if (a.s < b.s) return false;
  if (a.t != b.t) return a.t < b.t;
  return a.r < b.r;
}

// after every real candidate; pads partial lists shorter than k
__device__ __forceinline__ Key worst() { return Key{-INFINITY, INT_MAX, INT_MAX}; }

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }

// fixed-order dot product of one row with the query held in shared memory;
// every lane returns the same bits (each butterfly step adds the same two
// operands in both lanes of a pair).  Each element is widened to f32 in a
// register (exact for __half and int8_t) before its FMA.
template <class T>
__device__ __forceinline__ float warp_dot(const T* __restrict__ row,
                                          const float* __restrict__ qs,
                                          int d, int lane) {
  float acc = 0.f;
  for (int j = lane; j < d; j += 32) acc = fmaf(widen(row[j]), qs[j], acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// Dense rows of element type T, (N, d) row-major; the query operand is the
// query row (d floats).  kScaled: scales (N,) f32 multiply the finished dot.
template <class T, bool kScaled>
struct Dense {
  static constexpr bool kWarpPerRow = true;
  const T* emb;
  const float* scales;
  int d;
  __device__ float operator()(int row, const float* qs, int lane) const {
    const float s = warp_dot(emb + (size_t)row * d, qs, d, lane);
    return kScaled ? __fmul_rn(s, scales[row]) : s;
  }
};

// PQ codes (N, m) uint8; the query operand is its (m, 256) f32 lookup
// tables.  Codes are unsigned: a code is a table index 0..255.
struct PQ {
  static constexpr bool kWarpPerRow = false;
  const uint8_t* codes;
  int m;
  __device__ float operator()(int row, const float* lut, int) const {
    const uint8_t* c = codes + (size_t)row * m;
    float acc = 0.f;
    for (int j = 0; j < m; ++j) acc = __fadd_rn(acc, lut[j * 256 + c[j]]);
    return acc;
  }
};

__device__ __forceinline__ Key warp_best(Key k) {
  for (int off = 16; off > 0; off >>= 1) {
    Key o{__shfl_xor_sync(kFull, k.s, off), __shfl_xor_sync(kFull, k.t, off),
          __shfl_xor_sync(kFull, k.r, off)};
    if (before(o, k)) k = o;
  }
  return k;
}

// the block's best key; sh holds kWarps + 1 keys
__device__ __forceinline__ Key block_best(Key k, Key* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  k = warp_best(k);
  if (lane == 0) sh[warp] = k;
  __syncthreads();
  if (warp == 0) {
    Key w = lane < kWarps ? sh[lane] : worst();
    w = warp_best(w);
    if (lane == 0) sh[kWarps] = w;
  }
  __syncthreads();
  Key out = sh[kWarps];
  __syncthreads();  // sh is reused by the next round
  return out;
}

// Writes the best k of `count` candidates (keys from load(c)) in order.
// Round i takes the best key strictly after round i-1's, so nothing is
// marked or moved.  Candidates must have distinct keys (r is unique).
template <class Load>
__device__ void select_topk(int count, int k, const Load& load, float* out_v,
                            int* out_t, int* out_r, Key* sh) {
  Key prev = worst();
  for (int i = 0; i < k; ++i) {
    Key best = worst();
    for (int c = threadIdx.x; c < count; c += blockDim.x) {
      Key x = load(c);
      if ((i == 0 || before(prev, x)) && before(x, best)) best = x;
    }
    best = block_best(best, sh);
    if (threadIdx.x == 0) {
      out_v[i] = best.s;
      if (out_t) out_t[i] = best.t;
      out_r[i] = best.r;
    }
    prev = best;
  }
}

constexpr int kNotProbed = 1 << 30;

struct ChunkKeys {
  const float* sc;
  const int* vt;
  int row0;
  __device__ Key operator()(int c) const {
    return Key{sc[c], vt[c], row0 + c};
  }
};

struct Partial {
  const float* v;
  const int* t;
  const int* r;
  __device__ Key operator()(int c) const { return Key{v[c], t[c], r[c]}; }
};

// q: (Q, qlen) query operands (query rows, or PQ lookup tables)
template <class Scorer>
__global__ void __launch_bounds__(kThreads)
score_select(Scorer score, const float* __restrict__ q, int qlen,
             const int* __restrict__ virt, int n, int k, float* part_v,
             int* part_t, int* part_r) {
  extern __shared__ float smem[];
  float* qs = smem;                                 // (qlen,) query operand
  float* sc = smem + qlen;                          // (kChunk,) chunk scores
  int* vt = reinterpret_cast<int*>(sc + kChunk);    // (kChunk,) tie keys
  __shared__ Key red[kWarps + 1];
  const int chunk = blockIdx.x, qi = blockIdx.y;
  const int row0 = chunk * kChunk;
  const int rows = min(kChunk, n - row0);
  for (int j = threadIdx.x; j < qlen; j += blockDim.x)
    qs[j] = q[(size_t)qi * qlen + j];
  for (int c = threadIdx.x; c < rows; c += blockDim.x) {
    const int v = virt[(size_t)qi * n + row0 + c];
    vt[c] = v < kNotProbed ? v : kNotProbed;
  }
  __syncthreads();
  if constexpr (Scorer::kWarpPerRow) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < rows; r += kWarps) {
      float s = kNegInf;
      if (vt[r] < kNotProbed)  // warp-uniform: non-members unread
        s = score(row0 + r, qs, lane);
      if (lane == 0) sc[r] = s;
    }
  } else {
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      sc[r] = vt[r] < kNotProbed ? score(row0 + r, qs, 0) : kNegInf;
  }
  __syncthreads();
  const size_t base = ((size_t)qi * gridDim.x + chunk) * k;
  select_topk(rows, k, ChunkKeys{sc, vt, row0}, part_v + base,
              part_t + base, part_r + base, red);
}

__global__ void __launch_bounds__(kThreads)
merge(const float* __restrict__ part_v, const int* __restrict__ part_t,
      const int* __restrict__ part_r, int nchunks, int k, float* out_v,
      int* out_r) {
  __shared__ Key red[kWarps + 1];
  const int qi = blockIdx.x;
  const size_t base = (size_t)qi * nchunks * k;
  select_topk(nchunks * k, k,
              Partial{part_v + base, part_t + base, part_r + base},
              out_v + (size_t)qi * k, nullptr, out_r + (size_t)qi * k, red);
}

// Both passes on `stream`.  q: (Q, qlen) query operands; part_v / part_t /
// part_r: (Q, ceil(N / kChunk), k) scratch.
// The query operand and the chunk's scores sit in dynamic shared memory;
// past the default 48 KB (PQ tables of m > 46) the kernel opts in to the
// device's per-block maximum, and a larger operand gives
// cudaErrorInvalidValue.  Returns a cudaError_t.
template <class Scorer>
int launch(const Scorer& score, const float* q, int qlen, const int* virt,
           int n, int nq, int k, float* part_v, int* part_t, int* part_r,
           float* out_v, int* out_r, cudaStream_t stream) {
  const size_t smem = (size_t)qlen * sizeof(float) +
                      (size_t)kChunk * (sizeof(float) + sizeof(int));
  if (n <= 0 || qlen <= 0 || nq <= 0 || k <= 0 || k > n || nq > 65535 ||
      smem > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const auto kernel = score_select<Scorer>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset it, so the next launch does not report it
      return (int)err;
    }
  }
  const int nchunks = (n + kChunk - 1) / kChunk;
  kernel<<<dim3(nchunks, nq), kThreads, smem, stream>>>(
      score, q, qlen, virt, n, k, part_v, part_t, part_r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge<<<nq, kThreads, 0, stream>>>(part_v, part_t, part_r, nchunks, k,
                                     out_v, out_r);
  return (int)cudaGetLastError();
}

}  // namespace topk
