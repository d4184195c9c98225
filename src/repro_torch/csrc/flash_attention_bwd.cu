// flash_attention_bwd: the gradient of the GQA prefill attention
// (flash_attention.cu, K5) with respect to q, k and v, for Hopper (sm_90a),
// in f32 on the CUDA cores.
//
// Replaces: no TPU kernel.  The JAX package differentiates its plain jnp
// attention (src/repro/models/model.py, under jax.value_and_grad in
// src/repro/train/train_step.py); no Pallas kernel there has a backward.
// The port's model runs K5 in every attention layer on the card, so its
// training needs K5's gradient, and this kernel is it (bound through a
// torch.autograd.Function in kernels/flash_attention/ops.py).
//
// Contract (the plain version, kernels/flash_attention/ref.py::
// flash_attention_bwd_ref): contiguous f32 q, out, dout (B, Sq, H, D), k, v
// (B, Skv, KH, D), lse (B, H, Sq), the row log-sum-exp that K5 writes when
// asked.  With S = (q . k) * D^-0.5 under K5's masks (causal keeps
// k <= q, a window > 0 keeps k > q - window, positions from 0 for q and
// k):
//   P = exp(S - lse) where the mask keeps (i, j), else 0 -- but a row with
//       no valid key at all (a window and q >= Skv + window - 1) has the
//       uniform P = 1 / Skv that K5's -1e30 masked scores give it;
//   dV = P^T dO, dP = dO V^T, Di = rowsum(dO o O), dS = P o (dP - Di) where
//   the mask keeps (i, j), else 0 (the masked scores are constants);
//   dQ = dS K D^-0.5, dK = dS^T Q D^-0.5,
// dK and dV summed over the H / KH query heads of each kv head.  dq, dk,
// dv are written contiguous, in the layouts of q and k.
//
// What bounds it on this card: the operations.  At stablelm-1.6b's
// training shape (1, 4096, 32, 64) causal, the five products (S, dP, dV,
// dK, dQ) are 1.72e11 FLOP under the mask, 2.57 ms at the 67 TFLOP/s of
// f32 on the CUDA cores, against 0.13 ms for its 436 MB of operands.  This
// kernel issues seven (S and dP again in the dQ pass): 2.4e11.
//
// Design (a first kernel, right and simple; the tensor cores, as K5 uses
// them in 3xTF32, are later work).  Three launches, no atomics, so every
// sum runs in one fixed order and a call gives the same bits every time:
//   1. prep: Di for every row, one warp a row, a fixed butterfly.
//   2. dkv: a block per (KV tile of kBK keys, kv head, batch) holds its K
//      and V rows in shared memory and dK, dV in registers, and walks the
//      H / KH query heads of its group and, for each, the q tiles that the
//      masks leave anything in (and those holding rows with no valid key).
//      Per q tile it stages Q, dO, lse and Di, forms S and dP in registers,
//      P then dS through one shared tile, and adds P^T dO and dS^T Q.
//   3. dq: a block per (q tile, head, batch) holds Q, dO, lse and Di and dQ
//      in registers, walks the KV tiles in its causal / window range, forms
//      S, P, dP and dS again and adds dS K.
// Every product is a 16 x 16 grid of threads, each holding a register tile
// of (rows / 16) x (cols / 16) sums; shared rows are padded by one float so
// that a column read by 16 threads hits 16 banks.  Tiles are 64 x 64
// (D <= 128) and 32 x 32 at D = 256, where 64-row tiles of K, V, Q and dO
// would need 263 KB of shared memory.
#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads

template <int D>
struct Tile {
  static constexpr int kBQ = D > 128 ? 32 : 64;   // query rows a tile
  static constexpr int kBK = D > 128 ? 32 : 64;   // key rows a tile
  static constexpr int kP = D + 1;                // pitch of a row of D
  static constexpr int kPS = kBK + 1;             // pitch of a P / dS row
  static constexpr int kMI = kBQ / 16;            // a thread's query rows
  static constexpr int kMJ = kBK / 16;            // its keys
  static constexpr int kMC = D / 16;              // its dims
  static constexpr int kFloats =
      2 * kBK * kP + 2 * kBQ * kP + kBQ * kPS + 2 * kBQ;
  static constexpr int kBytes = kFloats * 4;
};

// rows r0 .. r0 + n - 1 of a (rows, ld) matrix into dst (pitch kP), rows at
// or past ``limit`` as zeros
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ld, int r0, int n,
                                      int limit) {
  constexpr int kP = D + 1;
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    dst[r * kP + c] = r0 + r < limit ? src[(long long)(r0 + r) * ld + c]
                                     : 0.f;
  }
}

__device__ __forceinline__ bool keeps(int i, int j, int causal, int window) {
  return (!causal || j <= i) && (window <= 0 || j > i - window);
}

// Di[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; a warp a row
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep(const float* __restrict__ out, const float* __restrict__ dout,
               float* __restrict__ di, int rows, int sq, int h, int d) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                 // row = (b * Sq + i) * H + head
  const float* o = out + (long long)row * d;
  const float* g = dout + (long long)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += o[c] * g[c];
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_xor_sync(attn::kFull, s, off);
  if (lane == 0) {
    const int head = row % h, bi = row / h, i = bi % sq, b = bi / sq;
    di[((long long)b * h + head) * sq + i] = s;
  }
}

// S (scaled) for the thread's (row ty + 16a, key tx + 16c) of the tile:
// rows of ``a_s`` against rows of ``b_s``, both pitch kP
template <int D, int kMI, int kMJ>
__device__ __forceinline__ void row_dots(float (&acc)[kMI][kMJ],
                                         const float* a_s,
                                         const float* b_s) {
  constexpr int kP = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < kMI; ++a)
#pragma unroll
    for (int c = 0; c < kMJ; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    float av[kMI], bv[kMJ];
#pragma unroll
    for (int a = 0; a < kMI; ++a) av[a] = a_s[(ty + 16 * a) * kP + e];
#pragma unroll
    for (int c = 0; c < kMJ; ++c) bv[c] = b_s[(tx + 16 * c) * kP + e];
#pragma unroll
    for (int a = 0; a < kMI; ++a)
#pragma unroll
      for (int c = 0; c < kMJ; ++c) acc[a][c] += av[a] * bv[c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              float* __restrict__ dk, float* __restrict__ dv, int sq, int skv,
              int h, int kh, int causal, int window, float scale) {
  using Tl = Tile<D>;
  constexpr int kBQ = Tl::kBQ, kBK = Tl::kBK, kP = Tl::kP, kPS = Tl::kPS;
  constexpr int kMI = Tl::kMI, kMJ = Tl::kMJ, kMC = Tl::kMC;
  extern __shared__ float smem[];
  float* const ks = smem;                 // kBK x kP
  float* const vs = ks + kBK * kP;
  float* const qs = vs + kBK * kP;        // kBQ x kP
  float* const dos = qs + kBQ * kP;
  float* const ps = dos + kBQ * kP;       // kBQ x kPS: P, then dS
  float* const ls = ps + kBQ * kPS;       // kBQ: lse
  float* const dis = ls + kBQ;            // kBQ: Di
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int group = h / kh;
  const long long ldq = (long long)h * D, ldk = (long long)kh * D;
  const float inv_skv = 1.f / (float)skv;

  stage<D>(ks, k + ((long long)b * skv * kh + hk) * D, ldk, k0, kBK, skv);
  stage<D>(vs, v + ((long long)b * skv * kh + hk) * D, ldk, k0, kBK, skv);

  // the query rows this KV tile meets: [lo, hi] under the masks, and the
  // rows with no valid key at all, [dead0, Sq) (only under a window)
  const int k_last = min(k0 + kBK, skv) - 1;
  const int lo = causal ? k0 : 0;
  const int hi = window > 0 ? min(sq - 1, k_last + window - 1) : sq - 1;
  const int dead0 = window > 0 ? skv + window - 1 : sq;

  float dka[kMJ][kMC], dva[kMJ][kMC];
#pragma unroll
  for (int c = 0; c < kMJ; ++c)
#pragma unroll
    for (int e = 0; e < kMC; ++e) dka[c][e] = dva[c][e] = 0.f;

  const int n_tiles = (sq + kBQ - 1) / kBQ;
  for (int hh = 0; hh < group; ++hh) {
    const int head = hk * group + hh;
    const float* qb = q + ((long long)b * sq * h + head) * D;
    const float* gb = dout + ((long long)b * sq * h + head) * D;
    const float* lb = lse + ((long long)b * h + head) * sq;
    const float* db = di + ((long long)b * h + head) * sq;
    for (int t = lo / kBQ; t < n_tiles; ++t) {
      const int q0 = t * kBQ, q1 = min(q0 + kBQ, sq) - 1;
      if (!((q0 <= hi && q1 >= lo) || q1 >= dead0)) continue;
      __syncthreads();     // the last tile's reads of qs, dos, ps are done
      stage<D>(qs, qb, ldq, q0, kBQ, sq);
      stage<D>(dos, gb, ldq, q0, kBQ, sq);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        ls[i] = q0 + i < sq ? lb[q0 + i] : 0.f;
        dis[i] = q0 + i < sq ? db[q0 + i] : 0.f;
      }
      __syncthreads();

      float p[kMI][kMJ], dp[kMI][kMJ];
      row_dots<D, kMI, kMJ>(p, qs, ks);
      row_dots<D, kMI, kMJ>(dp, dos, vs);
      bool ok[kMI][kMJ];
#pragma unroll
      for (int a = 0; a < kMI; ++a)
#pragma unroll
        for (int c = 0; c < kMJ; ++c) {
          const int r = ty + 16 * a, i = q0 + r, j = k0 + tx + 16 * c;
          const bool live = i < sq && j < skv;
          ok[a][c] = live && keeps(i, j, causal, window);
          const bool dead = live && i >= dead0;
          p[a][c] = ok[a][c] ? expf(p[a][c] * scale - ls[r])
                             : (dead ? inv_skv : 0.f);
          ps[r * kPS + tx + 16 * c] = p[a][c];
        }
      __syncthreads();
      // dV += P^T dO: the thread's keys ty + 16c, dims tx + 16e
#pragma unroll 2
      for (int i = 0; i < kBQ; ++i) {
        float pv[kMJ], gv[kMC];
#pragma unroll
        for (int c = 0; c < kMJ; ++c) pv[c] = ps[i * kPS + ty + 16 * c];
#pragma unroll
        for (int e = 0; e < kMC; ++e) gv[e] = dos[i * kP + tx + 16 * e];
#pragma unroll
        for (int c = 0; c < kMJ; ++c)
#pragma unroll
          for (int e = 0; e < kMC; ++e) dva[c][e] += pv[c] * gv[e];
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < kMI; ++a)
#pragma unroll
        for (int c = 0; c < kMJ; ++c) {
          const int r = ty + 16 * a;
          ps[r * kPS + tx + 16 * c] =
              ok[a][c] ? p[a][c] * (dp[a][c] - dis[r]) : 0.f;
        }
      __syncthreads();
      // dK += dS^T Q
#pragma unroll 2
      for (int i = 0; i < kBQ; ++i) {
        float sv[kMJ], qv[kMC];
#pragma unroll
        for (int c = 0; c < kMJ; ++c) sv[c] = ps[i * kPS + ty + 16 * c];
#pragma unroll
        for (int e = 0; e < kMC; ++e) qv[e] = qs[i * kP + tx + 16 * e];
#pragma unroll
        for (int c = 0; c < kMJ; ++c)
#pragma unroll
          for (int e = 0; e < kMC; ++e) dka[c][e] += sv[c] * qv[e];
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kMJ; ++c) {
    const int j = k0 + ty + 16 * c;
    if (j >= skv) continue;
    const long long off = ((long long)b * skv + j) * ldk + (long long)hk * D;
#pragma unroll
    for (int e = 0; e < kMC; ++e) {
      dk[off + tx + 16 * e] = dka[c][e] * scale;
      dv[off + tx + 16 * e] = dva[c][e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             float* __restrict__ dq, int sq, int skv, int h, int kh,
             int causal, int window, float scale) {
  using Tl = Tile<D>;
  constexpr int kBQ = Tl::kBQ, kBK = Tl::kBK, kP = Tl::kP, kPS = Tl::kPS;
  constexpr int kMI = Tl::kMI, kMJ = Tl::kMJ, kMC = Tl::kMC;
  extern __shared__ float smem[];
  float* const ks = smem;                 // kBK x kP
  float* const vs = ks + kBK * kP;
  float* const qs = vs + kBK * kP;        // kBQ x kP
  float* const dos = qs + kBQ * kP;
  float* const ps = dos + kBQ * kP;       // kBQ x kPS: dS
  float* const ls = ps + kBQ * kPS;
  float* const dis = ls + kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ, head = blockIdx.y, b = blockIdx.z;
  const int hk = head / (h / kh);
  const long long ldq = (long long)h * D, ldk = (long long)kh * D;

  stage<D>(qs, q + ((long long)b * sq * h + head) * D, ldq, q0, kBQ, sq);
  stage<D>(dos, dout + ((long long)b * sq * h + head) * D, ldq, q0, kBQ, sq);
  const float* lb = lse + ((long long)b * h + head) * sq;
  const float* db = di + ((long long)b * h + head) * sq;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    ls[i] = q0 + i < sq ? lb[q0 + i] : 0.f;
    dis[i] = q0 + i < sq ? db[q0 + i] : 0.f;
  }

  // the keys the tile's rows may attend (rows with none get dS = 0)
  const int q1 = min(q0 + kBQ, sq) - 1;
  const int jlo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int jhi = causal ? min(q1, skv - 1) : skv - 1;

  float dqa[kMI][kMC];
#pragma unroll
  for (int a = 0; a < kMI; ++a)
#pragma unroll
    for (int e = 0; e < kMC; ++e) dqa[a][e] = 0.f;

  const float* kb = k + ((long long)b * skv * kh + hk) * D;
  const float* vb = v + ((long long)b * skv * kh + hk) * D;
  for (int t = jlo / kBK; jlo <= jhi && t <= jhi / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();       // the last tile's reads of ks, vs, ps are done
    stage<D>(ks, kb, ldk, k0, kBK, skv);
    stage<D>(vs, vb, ldk, k0, kBK, skv);
    __syncthreads();
    float s[kMI][kMJ], dp[kMI][kMJ];
    row_dots<D, kMI, kMJ>(s, qs, ks);
    row_dots<D, kMI, kMJ>(dp, dos, vs);
#pragma unroll
    for (int a = 0; a < kMI; ++a)
#pragma unroll
      for (int c = 0; c < kMJ; ++c) {
        const int r = ty + 16 * a, i = q0 + r, j = k0 + tx + 16 * c;
        const bool ok = i < sq && j < skv && keeps(i, j, causal, window);
        ps[r * kPS + tx + 16 * c] =
            ok ? expf(s[a][c] * scale - ls[r]) * (dp[a][c] - dis[r]) : 0.f;
      }
    __syncthreads();
    // dQ += dS K: the thread's rows ty + 16a, dims tx + 16e
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float sv[kMI], kv[kMC];
#pragma unroll
      for (int a = 0; a < kMI; ++a) sv[a] = ps[(ty + 16 * a) * kPS + j];
#pragma unroll
      for (int e = 0; e < kMC; ++e) kv[e] = ks[j * kP + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < kMI; ++a)
#pragma unroll
        for (int e = 0; e < kMC; ++e) dqa[a][e] += sv[a] * kv[e];
    }
  }

#pragma unroll
  for (int a = 0; a < kMI; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= sq) continue;
    const long long off = ((long long)b * sq + i) * ldq + (long long)head * D;
#pragma unroll
    for (int e = 0; e < kMC; ++e) dq[off + tx + 16 * e] = dqa[a][e] * scale;
  }
}

template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) cudaGetLastError();   // do not report it twice
  return (int)err;
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* out,
           const float* dout, const float* lse, float* di, float* dq,
           float* dk, float* dv, int b, int sq, int skv, int h, int kh,
           int causal, int window, float scale, cudaStream_t stream) {
  using Tl = Tile<D>;
  const long long rows = (long long)b * sq * h;
  if (rows > 0x7fffffffLL / 2) return (int)cudaErrorInvalidValue;
  const int warps = kThreads / 32;
  flash_bwd_prep<<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                   stream>>>(out, dout, di, (int)rows, sq, h, D);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if ((err = set_smem(flash_bwd_dkv<D>, Tl::kBytes))) return err;
  const dim3 grid_kv((skv + Tl::kBK - 1) / Tl::kBK, kh, b);
  flash_bwd_dkv<D><<<grid_kv, kThreads, Tl::kBytes, stream>>>(
      q, k, v, dout, lse, di, dk, dv, sq, skv, h, kh, causal, window, scale);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(flash_bwd_dq<D>, Tl::kBytes))) return err;
  const dim3 grid_q((sq + Tl::kBQ - 1) / Tl::kBQ, h, b);
  flash_bwd_dq<D><<<grid_q, kThreads, Tl::kBytes, stream>>>(
      q, k, v, dout, lse, di, dq, sq, skv, h, kh, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 only.  Every tensor is contiguous: q, out, dout, dq (B, Sq, H, D); k,
// v, dk, dv (B, Skv, KH, D); lse and the scratch di (B, H, Sq).  Returns a
// cudaError_t (cudaErrorInvalidValue for a head dim other than 64, 80, 128
// or 256, or shapes the grid cannot hold).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* di, void* dq, void* dk, void* dv,
                                   int b, int sq, int skv, int h, int kh,
                                   int d, int causal, int window, float scale,
                                   cudaStream_t stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kh < 1 || h % kh != 0 ||
      sq < 1 || skv < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  return attn::by_dim<float, 64, 80, 128, 256>(d, [&](auto, auto dim) {
    constexpr int D = decltype(dim)::value;
    return launch<D>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(out),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(di), static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), b, sq, skv, h, kh,
        causal, window, scale, stream);
  });
}
