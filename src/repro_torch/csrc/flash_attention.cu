// flash_attention: GQA prefill attention with an online softmax, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (the TPU kernel whose sequential KV grid axis
// carries the running max, denominator and (BQ, D) accumulator in VMEM
// scratch across KV blocks).
//
// Contract (the plain version, kernels/flash_attention/ref.py): q (B, Sq, H,
// D), k / v (B, Skv, KH, D), H % KH == 0, f32 or bf16, read in place through
// their strides (the head dim contiguous).  Query head h reads kv head
// h / (H / KH).  Scores are (q * D^-0.5) . k in f32; the causal mask keeps
// k <= q and the window (if > 0) keeps k > q - window, with positions
// counted from 0 for q and for k; masked scores are -1e30, as in the TPU
// kernel, so a row whose every key is masked gets the mean of V, as the
// plain softmax gives it.  out = acc / max(l, 1e-20), written (B, Sq, H, D)
// in q's dtype.  Any Sq, Skv >= 1: the ragged tails are masked here (the TPU
// kernel's "pad seq to block multiple" is a limit of its tiling).
//
// Design.  One block per (64-row query tile, query head, batch row), 128
// threads: four threads per pair of query rows (r and r + 32 of the tile),
// thread p of a pair owning the head dims p, p + 4, p + 8, ... of both rows'
// q (pre-scaled) and accumulators, in registers.  The block walks the KV
// sequence in 32-row tiles staged in shared memory as f32 (20 KB at
// D = 80), shared by all 64 query rows: a tile is read from device memory
// once per query tile, not once per row.  Every K or V value a thread reads
// from shared memory feeds two FMAs (its two rows), and the eight pairs of a
// warp read the same four consecutive floats, one broadcast wavefront.  A
// score is the owner's D/4 FMAs in ascending order and a fixed two-step xor
// butterfly across the four owners, so every score has one reduction order
// whatever B, Sq or the tile position: a batch gives bitwise the result of
// its rows run one at a time.  Per tile, each row takes the tile's max,
// rescales (alpha = exp(m - m_new)) and adds p_j v_j, as the TPU kernel does
// per KV block.  KV tiles that the causal mask or the window mask entirely
// are skipped (kernel.py:46-53) -- unless the query tile holds a row with
// no valid key at all (possible only under a window with
// q >= Skv + window - 1), which must see every key to return the mean.
//
// What bounds it on this card: at the main path's prefill shape the work
// is small (~0.08 GFLOP causal, ~5 MB) and launch latency bounds it.  At
// the encode shape (12.9 GFLOP) it is the CUDA cores' f32 FMAs, two per
// shared-memory read, against 67 TFLOP/s; tensor cores (wgmma over
// TMA-staged tiles) are later work.
#include "attention_common.cuh"

namespace {

using attn::kFull;
using attn::kNegInf;
using attn::store;
using attn::Strides;
using attn::widen;

constexpr int kBQ = 64;                      // query rows per block
constexpr int kBK = 32;                      // KV rows per shared-memory tile
constexpr int kSplit = 4;                    // threads per pair of rows
constexpr int kThreads = kBQ / 2 * kSplit;   // 128

template <class T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, Strides qs,
          Strides ks_, Strides vs_, Strides os, int sq, int skv, int group,
          int causal, int window, float scale) {
  constexpr int kPer = D / kSplit;   // dims a thread owns: p + 4i
  extern __shared__ float smem[];
  float* kt = smem;             // (kBK, D) keys of the current tile
  float* vt = smem + kBK * D;   // (kBK, D) values
  const int head = blockIdx.y, b = blockIdx.z;
  const int hk = head / group;
  const int pair = threadIdx.x / kSplit, part = threadIdx.x % kSplit;
  const int q0 = blockIdx.x * kBQ;
  const int qi[2] = {q0 + pair, q0 + pair + kBQ / 2};

  float qr[2][kPer], acc[2][kPer], m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = qi[r] < sq;
    const T* qp = q + b * qs.b + (long long)(live ? qi[r] : 0) * qs.s +
                  head * qs.h + part;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      qr[r][i] = live ? widen(qp[kSplit * i]) * scale : 0.f;
      acc[r][i] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const int q_last = min(q0 + kBQ, sq) - 1;
  const bool may_skip = !(window > 0 && q_last >= skv + window - 1);
  const T* kb = k + b * ks_.b + hk * ks_.h;
  const T* vb = v + b * vs_.b + hk * vs_.h;
  for (int kv0 = 0; kv0 < skv; kv0 += kBK) {
    const int kv_last = min(kv0 + kBK, skv) - 1;
    if (may_skip) {
      if (causal && kv0 > q_last) break;                 // all in the future
      if (window > 0 && kv_last <= q0 - window) continue;  // all behind
    }
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < kBK * D; t += kThreads) {
      const int r = t / D, d = t - r * D;
      const int kj = kv0 + r;
      float kx = 0.f, vx = 0.f;
      if (kj < skv) {
        kx = widen(kb[(long long)kj * ks_.s + d]);
        vx = widen(vb[(long long)kj * vs_.s + d]);
      }
      kt[t] = kx;
      vt[t] = vx;
    }
    __syncthreads();

    float s[2][kBK], mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float* kr = kt + j * D + part;
      float a[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float x = kr[kSplit * i];
        a[0] = fmaf(qr[0][i], x, a[0]);
        a[1] = fmaf(qr[1][i], x, a[1]);
      }
      const int kj = kv0 + j;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        a[r] += __shfl_xor_sync(kFull, a[r], 1);
        a[r] += __shfl_xor_sync(kFull, a[r], 2);
        bool ok = true;
        if (causal) ok = kj <= qi[r];
        if (window > 0) ok = ok && kj > qi[r] - window;
        // a key past Skv does not exist: exp(-inf - mx) adds exactly nothing
        s[r][j] = kj < skv ? (ok ? a[r] : kNegInf) : -INFINITY;
        mx[r] = fmaxf(mx[r], s[r][j]);
      }
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float alpha = expf(m[r] - mx[r]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[r][i] *= alpha;
      l[r] *= alpha;
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p0 = expf(s[0][j] - mx[0]), p1 = expf(s[1][j] - mx[1]);
      psum[0] += p0;
      psum[1] += p1;
      const float* vr = vt + j * D + part;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float x = vr[kSplit * i];
        acc[0][i] = fmaf(p0, x, acc[0][i]);
        acc[1][i] = fmaf(p1, x, acc[1][i]);
      }
    }
    l[0] += psum[0];
    l[1] += psum[1];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= sq) continue;
    const float den = fmaxf(l[r], 1e-20f);
    T* op = out + b * os.b + (long long)qi[r] * os.s + head * os.h + part;
#pragma unroll
    for (int i = 0; i < kPer; ++i) store(op + kSplit * i, acc[r][i] / den);
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  Strides are in elements; out is a
// contiguous (B, Sq, H, D) tensor of q's dtype.  Returns a cudaError_t
// (cudaErrorInvalidValue for a head dim other than 64, 80 or 128, or shapes
// the grid cannot hold).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, long long qsb,
                               long long qss, long long qsh, long long ksb,
                               long long kss, long long ksh, long long vsb,
                               long long vss, long long vsh, int b, int sq,
                               int skv, int h, int kh, int d, int causal,
                               int window, float scale, cudaStream_t stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kh < 1 || h % kh != 0 ||
      sq < 1 || skv < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  return attn::dispatch<64, 80, 128>(dtype, d, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dim)::value;
    const int smem = 2 * kBK * D * (int)sizeof(float);  // <= 32 KB
    const Strides os{(long long)sq * h * D, (long long)h * D, D};
    const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
    flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, sq,
        skv, h / kh, causal, window, scale);
    return (int)cudaGetLastError();
  });
}
