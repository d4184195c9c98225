// The port's two top-k kernels (ivf_topk.cu, slab_topk.cu) share this code;
// each .cu is a thin extern "C" entry point over launch<kMasked>.
//
// Both kernels are two passes:
//   1. score + select: one block per (row chunk, query).  Each warp scores
//      whole rows; every (query, row) score is the same fixed-order fp32 sum
//      over D (lane-strided FMAs, then a fixed xor butterfly), so it does not
//      depend on Q, N or where the row falls in a chunk.  The block keeps the
//      chunk's best k candidates.
//   2. merge: one block per query selects the best k of all chunks' lists.
// Selection is under one TOTAL order -- score desc, then tie key asc, then
// row asc -- so the top k of the union of per-chunk top-k lists is the
// global top k, and a batch gives bitwise the result of its queries run one
// at a time.
//
// kMasked = false (ivf_topk): every row competes and the tie key is the row.
// kMasked = true (slab_topk): row r competes for query q only when
// virt[q, r] < kNotProbed, the tie key is virt[q, r], and non-members score
// kNegInf with key kNotProbed without their dot product being computed.
#pragma once

#include <climits>
#include <cmath>
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

// fixed-order dot product of one row with the query held in shared memory;
// every lane returns the same bits (each butterfly step adds the same two
// operands in both lanes of a pair)
__device__ __forceinline__ float warp_dot(const float* __restrict__ row,
                                          const float* __restrict__ qs,
                                          int d, int lane) {
  float acc = 0.f;
  for (int j = lane; j < d; j += 32) acc = fmaf(row[j], qs[j], acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

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

template <bool kMasked>
struct ChunkKeys {
  const float* sc;
  const int* vt;
  int row0;
  __device__ Key operator()(int c) const {
    return Key{sc[c], kMasked ? vt[c] : row0 + c, row0 + c};
  }
};

struct Partial {
  const float* v;
  const int* t;
  const int* r;
  __device__ Key operator()(int c) const { return Key{v[c], t[c], r[c]}; }
};

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
score_select(const float* __restrict__ emb, const float* __restrict__ q,
             const int* __restrict__ virt, int n, int d, int k, float* part_v,
             int* part_t, int* part_r) {
  extern __shared__ float smem[];
  float* qs = smem;                                 // (d,) this block's query
  float* sc = smem + d;                             // (kChunk,) chunk scores
  int* vt = reinterpret_cast<int*>(sc + kChunk);    // (kChunk,) if kMasked
  __shared__ Key red[kWarps + 1];
  const int chunk = blockIdx.x, qi = blockIdx.y;
  const int row0 = chunk * kChunk;
  const int rows = min(kChunk, n - row0);
  for (int j = threadIdx.x; j < d; j += blockDim.x) qs[j] = q[(size_t)qi * d + j];
  if (kMasked) {
    for (int c = threadIdx.x; c < rows; c += blockDim.x) {
      const int v = virt[(size_t)qi * n + row0 + c];
      vt[c] = v < kNotProbed ? v : kNotProbed;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    float s = kNegInf;
    if (!kMasked || vt[r] < kNotProbed)  // warp-uniform: non-members unread
      s = warp_dot(emb + (size_t)(row0 + r) * d, qs, d, lane);
    if (lane == 0) sc[r] = s;
  }
  __syncthreads();
  const size_t base = ((size_t)qi * gridDim.x + chunk) * k;
  select_topk(rows, k, ChunkKeys<kMasked>{sc, vt, row0}, part_v + base,
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

// Both passes on `stream`.  part_v / part_t / part_r: (Q, ceil(N / kChunk),
// k) scratch; virt is read only when kMasked.  Returns a cudaError_t.
template <bool kMasked>
int launch(const float* emb, const float* q, const int* virt, int n, int d,
           int nq, int k, float* part_v, int* part_t, int* part_r,
           float* out_v, int* out_r, cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(float) +
                      (size_t)kChunk * (sizeof(float) + (kMasked ? sizeof(int) : 0));
  if (n <= 0 || d <= 0 || nq <= 0 || k <= 0 || k > n || nq > 65535 ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int nchunks = (n + kChunk - 1) / kChunk;
  score_select<kMasked><<<dim3(nchunks, nq), kThreads, smem, stream>>>(
      emb, q, virt, n, d, k, part_v, part_t, part_r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge<<<nq, kThreads, 0, stream>>>(part_v, part_t, part_r, nchunks, k,
                                     out_v, out_r);
  return (int)cudaGetLastError();
}

}  // namespace topk
