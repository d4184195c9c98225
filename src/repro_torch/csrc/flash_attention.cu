// flash_attention: GQA prefill attention with an online softmax, for Hopper
// (sm_90a), on the tensor cores in 3xTF32.
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
// What bounds it on this card: the bytes.  At the encode shape (256, 128,
// 12, 64) q, k, v and the output are 402.7 MB, 0.120 ms at 3.35 TB/s; its
// 12.9 GFLOP take 0.078 ms at the 165 TFLOP/s the tensor cores give at f32
// accuracy (3xTF32, below: a third of their 495 TFLOP/s in TF32).  At the
// main path's prefill shape (1, 128, 32, 80) the work is small (5.2 MB,
// 0.0016 ms): a warp's sequential walk over the keys, not the card's rates,
// sets the time.  At gemma3-12b's prefill, (1, 2048, 16, 256) against 8 kv
// heads, the operations do: 25.8 GFLOP under the 1,024-key window (0.156
// ms at 165 TFLOP/s), 34.4 causal without it (0.208 ms), against 0.030 ms
// of bytes.
//
// Design.  A block is four warps; each warp owns 16 query rows.  Both
// products run on the tensor cores as mma.sync m16n8k8 in TF32:
// S = (q * D^-0.5) . K^T over 8-dim steps, and O += P . V over 8-key steps.
// TF32 keeps 10 mantissa bits, so each f32 operand x is split into a hi
// part rounded to nearest (Veltkamp: t = x * 8193, hi = t - (t - x), 11
// significant bits) and lo = x - hi (exact; the tensor core reads its top
// 11 bits), and every product is lo.hi + hi.lo + hi.hi, small terms first,
// into f32 accumulators (3xTF32, as CUTLASS's OpMultiplyAddFastF32 and
// PyTorch's f32 SDPA do): about f32 accuracy, where one TF32 product would
// miss the checks' bound by far.  (cvt.rna.tf32.f32 gives the same hi, but
// compiles to a longer integer sequence.)  P stays
// f32 and takes the same split; bf16 K / V widen exactly into TF32, so
// their lo is 0 and its product is not issued.  q, pre-scaled, lives in
// registers as f32 and is split per KV tile; S lives in the mma
// accumulators.  A thread holds two rows (g and g + 8 of its warp's 16) and
// computes the masks and exps of its own elements only; row max and row sum
// take a fixed two-step xor butterfly across the quad that shares a row,
// and the running sum stays per thread until the end.  S's accumulator
// layout is P . V's A operand once each 8-key slice is relabelled (A column
// t <-> key 2t, column t + 4 <-> key 2t + 1), with V's rows read in that
// order: no shuffle.  q . K's 8-dim steps are relabelled the same way
// (column t <-> dim 2t), so a thread's two K values are adjacent: one
// 8-byte shared-memory read.  K / V tiles are staged in shared memory in
// their own dtype by cp.async (16 bytes a thread, zero-filled past Skv), two
// stages, so the next tile's copy runs under this tile's mma; rows are
// padded (f32 K by 32 bytes, the rest by 16) so that every fragment read is
// conflict-free.  An operand whose address or strides are not multiples of
// 16 bytes is staged into the same tiles by plain loads instead.
//
// Head dim 256 (gemma3's): q's pre-scaled fragments (D / 2 floats a
// thread) beside O's accumulator (D / 2 more) would need 256 registers a
// thread before S, P and addresses, past the 255 a thread may hold, and a
// spill would put them in local memory.  So there q lives in shared memory
// instead, after the K / V stages: the block's query rows, pre-scaled in
// f32, rows padded by 32 bytes (a warp's 8-byte fragment reads then hit
// distinct banks), read per 8-dim step of each tile; O, S and P stay in
// registers.  The values are those the registers would hold, so the
// arithmetic and its order are unchanged.  The f32 tiles and q take
// 134,144 + 33,792 bytes causal (32 query rows) and + 67,584 non-causal
// (64 rows), under the 227 KB a block may have: one block an SM.  Head
// dims 64, 80 and 128 keep q in registers.
//
// Two layouts of the four warps, one per mask kind.  Non-causal (the
// encoder, over hundreds of texts: thousands of blocks): the four warps take
// 64 query rows and share each 32-row KV tile, so K / V cross from L2 once
// per 64 rows (and at D = 64 a 168-register cap keeps three blocks on an
// SM).  Causal (the generator's prefill of a few prompts: at the main
// path's shape 64 such blocks would leave half the SMs idle and walk 128
// keys a warp): two warps take 32 query rows and two more the same rows,
// each pair taking one half of every 64-row KV tile (D <= 80; 32 rows at
// D = 128 and 256), and the halves are merged at the end in one fixed order (m =
// max, both sides rescaled).  Twice the blocks, half the walk.  The layout
// reads only the mask kind, never B.
//
// mma.sync and not wgmma: wgmma in TF32 takes both operands K-major, so
// P . V would need V transposed in shared memory and P staged there too; a
// query tile here sees two to four KV tiles, and the staging, the softmax
// and the warp's walk, not the mma issue rate, are what bound it.
//
// Every output element's sums run in one order fixed by its own row and
// the mask kind (the mma of its row, the tile order, the quad butterfly,
// the merge), whatever B or the block's place in the grid: a batch gives
// bitwise the result of its rows run one at a time.  Per KV tile, each row
// takes the tile's max, rescales (alpha = exp(m - m_new)) and adds P . V, as
// the TPU kernel does per KV block.  KV tiles that the causal mask or the
// window masks entirely are skipped (kernel.py:46-53) -- unless the query
// tile holds a row with no valid key at all (possible only under a window
// with q >= Skv + window - 1), which must see every key to return the mean.
#include "attention_common.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::kFull;
using attn::kNegInf;
using attn::Strides;
using attn::widen;

constexpr int kThreads = 128;   // four warps

// The layout of one instantiation: kGroups warps share each 16 query rows,
// each taking kKeys of every kBK-row KV tile; tiles of D elements of T a
// row, padded, K and V, two stages.
template <class T, int D, int kGroups>
struct Layout {
  static constexpr int kRowWarps = 4 / kGroups;
  static constexpr int kBQ = 16 * kRowWarps;            // query rows a block
  static constexpr int kBK = D <= 80 ? 32 * kGroups : 32;
  static constexpr int kKeys = kBK / kGroups;           // a warp's share
  static constexpr int kVec = 16 / (int)sizeof(T);      // elements a copy
  static constexpr int kPitchK = D + (sizeof(T) == 4 ? 8 : kVec);
  static constexpr int kPitchV = D + kVec;
  static constexpr int kStage = kBK * (kPitchK + kPitchV);   // K then V
  static constexpr int kTileBytes = 2 * kStage * (int)sizeof(T);
  // q in shared memory (f32, rows padded by 8 floats) past D = 128
  static constexpr bool kQShared = D > 128;
  static constexpr int kPitchQ = D + 8;
  static constexpr int kBytes =
      kTileBytes + (kQShared ? kBQ * kPitchQ * 4 : 0);
  static constexpr int kMinBlocks = kGroups == 1 && D == 64 ? 3 : 1;
};

// x = hi + lo, hi rounded to nearest at 11 significant bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float t = __fmul_rn(x, 8193.f);
  const float h = __fsub_rn(t, __fsub_rn(t, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// c += a . b, one m16n8k8 TF32 product with f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in 3xTF32 for a split A and a B of two f32 values: exact in
// TF32 (bf16 K / V: lo is 0, one product fewer) or split too.
template <bool kExact>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  if constexpr (kExact) {
    const uint32_t bh[2] = {__float_as_uint(b0), __float_as_uint(b1)};
    mma(c, al, bh);
    mma(c, ah, bh);
  } else {
    uint32_t bh[2], bl[2];
    split(b0, bh[0], bl[0]);
    split(b1, bh[1], bl[1]);
    mma(c, al, bh);
    mma(c, ah, bl);
    mma(c, ah, bh);
  }
}

__device__ __forceinline__ float2 widen2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 widen2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Stages KV rows kv0 .. kv0 + kBK - 1 of one head into a tile, rows past
// Skv as zeros: by cp.async when ``vec`` (address and strides multiples of
// 16 bytes), else by plain loads.
template <class T, int D, int kBK, int kPitch>
__device__ __forceinline__ void stage(T* dst, const T* src, long long stride,
                                      int kv0, int skv, bool vec) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kChunks = D / kVec;   // 16-byte copies a row
  constexpr int kCopies = kBK * kChunks;
  if (vec) {
#pragma unroll
    for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (kCopies % kThreads != 0 && c >= kCopies) break;
      const int r = c / kChunks, e = (c - r * kChunks) * kVec;
      const bool ok = kv0 + r < skv;
      cp_async16(dst + r * kPitch + e,
                 src + (ok ? (long long)(kv0 + r) * stride : 0) + e, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int r = i / D, e = i - r * D;
      dst[r * kPitch + e] = kv0 + r < skv
          ? src[(long long)(kv0 + r) * stride + e] : T(0.f);
    }
  }
}

// kLse: also write each row's log-sum-exp (f32 only; the training path's
// forward, whose backward reads it); the serving entries are kLse = false,
// and compile as if the store were not there.
template <class T, int D, int kGroups, bool kLse>
__global__ void __launch_bounds__(
    kThreads, (kLse ? 1 : Layout<T, D, kGroups>::kMinBlocks))
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, Strides qs,
          Strides ks_, Strides vs_, Strides os, int sq, int skv, int group,
          int causal, int window, float scale, int vec,
          float* __restrict__ lse) {
  using Ly = Layout<T, D, kGroups>;
  constexpr int kBK = Ly::kBK, kPK = Ly::kPitchK, kPV = Ly::kPitchV;
  constexpr int kSteps = D / 8;           // 8-dim steps of q . k and of O
  constexpr int kSlices = Ly::kKeys / 8;  // a warp's 8-key slices a tile
  constexpr bool kExact = sizeof(T) == 2;   // bf16 K / V are TF32-exact
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const tiles = reinterpret_cast<T*>(smem_raw);  // K0 V0 K1 V1
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int warp = threadIdx.x / 32 % Ly::kRowWarps;    // its 16 rows
  const int part = threadIdx.x / (32 * Ly::kRowWarps);  // its keys
  const int head = blockIdx.y, b = blockIdx.z;
  const int hk = head / group;
  const int q0 = blockIdx.x * Ly::kBQ, w0 = q0 + warp * 16;
  const int rows[2] = {w0 + g, w0 + g + 8};

  // the KV tiles to walk: all of them, or those the masks leave anything in
  const int q_last = min(q0 + Ly::kBQ, sq) - 1;
  int first = 0, end = (skv + kBK - 1) / kBK;
  if (!(window > 0 && q_last >= skv + window - 1)) {
    if (causal) end = min(end, q_last / kBK + 1);
    if (window > 0)
      while (first < end && min((first + 1) * kBK, skv) - 1 <= q0 - window)
        ++first;
  }
  const T* kb = k + b * ks_.b + hk * ks_.h;
  const T* vb = v + b * vs_.b + hk * vs_.h;
  if (first < end) {
    stage<T, D, kBK, kPK>(tiles, kb, ks_.s, first * kBK, skv, vec);
    stage<T, D, kBK, kPV>(tiles + kBK * kPK, vb, vs_.s, first * kBK, skv,
                          vec);
    cp_async_commit();
  }

  // q * scale as A fragments, dims relabelled: [step][0] row g, dim 8s + 2t;
  // [1] row g + 8; [2] row g, dim 8s + 2t + 1; [3] row g + 8.  Past D = 128
  // the block's rows go to shared memory instead (the loop's first barrier
  // orders the writes before any read), fragments read from there per step.
  float qf[Ly::kQShared ? 1 : kSteps][4];
  float* const qsm = reinterpret_cast<float*>(smem_raw + Ly::kTileBytes);
  if constexpr (Ly::kQShared) {
    for (int i = threadIdx.x; i < Ly::kBQ * D; i += kThreads) {
      const int r = i / D, e = i - r * D;
      qsm[r * Ly::kPitchQ + e] =
          q0 + r < sq ? widen(q[b * qs.b + (long long)(q0 + r) * qs.s +
                                head * qs.h + e]) * scale
                      : 0.f;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool live = rows[r] < sq;
      const T* qp = q + b * qs.b + (long long)(live ? rows[r] : 0) * qs.s +
                    head * qs.h + 2 * t;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        qf[s][r] = live ? widen(qp[8 * s]) * scale : 0.f;
        qf[s][r + 2] = live ? widen(qp[8 * s + 1]) * scale : 0.f;
      }
    }
  }
  const float* const qw = qsm + (warp * 16 + g) * Ly::kPitchQ + 2 * t;
  // O as C fragments: [dim slice n][0, 1] row g, dims 8n + 2t, +1; [2, 3]
  // row g + 8
  float o[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};          // this thread's part of each row's sum

  for (int it = first; it < end; ++it) {
    const T* kt = tiles + ((it - first) & 1) * Ly::kStage;
    const T* vt = kt + kBK * kPK;
    if (it + 1 < end) {   // the next tile into the other stage
      T* nk = tiles + ((it + 1 - first) & 1) * Ly::kStage;
      stage<T, D, kBK, kPK>(nk, kb, ks_.s, (it + 1) * kBK, skv, vec);
      stage<T, D, kBK, kPV>(nk + kBK * kPK, vb, vs_.s, (it + 1) * kBK, skv,
                            vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int key0 = part * Ly::kKeys;    // this warp's keys in the tile
    const int kv0 = it * kBK + key0;

    // S = q . K^T: [slice j][0, 1] row g, keys 8j + 2t, +1; [2, 3] row g+8
    float sc[kSlices][4];
#pragma unroll
    for (int j = 0; j < kSlices; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t ah[4], al[4];
      float qv[4];
      if constexpr (Ly::kQShared) {
        const float2 lo = *reinterpret_cast<const float2*>(qw + 8 * s);
        const float2 hi =
            *reinterpret_cast<const float2*>(qw + 8 * Ly::kPitchQ + 8 * s);
        qv[0] = lo.x, qv[1] = hi.x, qv[2] = lo.y, qv[3] = hi.y;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qv[e] = qf[s][e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = qv[e];
        asm volatile("" : "+f"(x));   // split per tile, not held split
        split(x, ah[e], al[e]);
      }
#pragma unroll
      for (int j = 0; j < kSlices; ++j) {   // B: key g, dims 2t, 2t + 1
        const float2 kk = widen2(kt + (key0 + 8 * j + g) * kPK + 8 * s +
                                 2 * t);
        mma3<kExact>(sc[j], ah, al, kk.x, kk.y);
      }
    }

    // masks where the warp's rows and keys need them, the tile's row max,
    // the rescale and P = exp(S - m)
    float mx[2] = {m[0], m[1]};
    const bool edge = (causal && kv0 + Ly::kKeys - 1 > w0) ||
                      (window > 0 && kv0 <= w0 + 15 - window) ||
                      kv0 + Ly::kKeys > skv;
#pragma unroll
    for (int j = 0; j < kSlices; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int kj = kv0 + 8 * j + 2 * t + (e & 1), qi = rows[e >> 1];
          bool ok = true;
          if (causal) ok = kj <= qi;
          if (window > 0) ok = ok && kj > qi - window;
          // a key past Skv does not exist: exp(-inf - mx) adds exactly 0
          sc[j][e] = kj < skv ? (ok ? sc[j][e] : kNegInf) : -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float alpha = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < kSlices; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - mx[e >> 1]);
        l[e >> 1] += sc[j][e];
      }

    // O += P . V, slice j's A relabelled: column t <-> key 2t, t+4 <-> 2t+1
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      uint32_t ph[4], pl[4];
      split(sc[j][0], ph[0], pl[0]);   // row g,     key 2t
      split(sc[j][2], ph[1], pl[1]);   // row g + 8, key 2t
      split(sc[j][1], ph[2], pl[2]);   // row g,     key 2t + 1
      split(sc[j][3], ph[3], pl[3]);   // row g + 8, key 2t + 1
      const T* vr = vt + (key0 + 8 * j + 2 * t) * kPV + g;   // B: dim g
#pragma unroll
      for (int n = 0; n < kSteps; ++n)
        mma3<kExact>(o[n], ph, pl, widen(vr[8 * n]), widen(vr[kPV + 8 * n]));
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  if constexpr (kGroups == 2) {
    // the second half's (m, l, O) through shared memory into the first's:
    // m = max of both, each side rescaled to it, first half first
    constexpr int kN = 32 * Ly::kRowWarps;
    float* xs = reinterpret_cast<float*>(smem_raw);
    const int slot = threadIdx.x % kN;
    if (first >= end) __syncthreads();   // no tile loop ended on one
    if (part == 1) {
#pragma unroll
      for (int n = 0; n < kSteps; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[(4 * n + e) * kN + slot] = o[n][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xs[(4 * kSteps + r) * kN + slot] = m[r];
        xs[(4 * kSteps + 2 + r) * kN + slot] = l[r];
      }
    }
    __syncthreads();
    if (part == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xs[(4 * kSteps + r) * kN + slot];
      const float l1 = xs[(4 * kSteps + 2 + r) * kN + slot];
      const float mn = fmaxf(m[r], m1);
      const float a0 = expf(m[r] - mn), a1 = expf(m1 - mn);
      l[r] = l[r] * a0 + l1 * a1;
      if constexpr (kLse) m[r] = mn;   // the row's (m, l), for its lse
#pragma unroll
      for (int n = 0; n < kSteps; ++n)
#pragma unroll
        for (int c = 2 * r; c < 2 * r + 2; ++c)
          o[n][c] = o[n][c] * a0 + xs[(4 * n + c) * kN + slot] * a1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    if (rows[r] >= sq) continue;
    const float den = fmaxf(l[r], 1e-20f);
    if constexpr (kLse) {
      if (t == 0)   // the quad holds one (m, l) a row
        lse[((long long)b * gridDim.y + head) * sq + rows[r]] =
            m[r] + logf(den);
    }
    T* op = out + b * os.b + (long long)rows[r] * os.s + head * os.h + 2 * t;
#pragma unroll
    for (int n = 0; n < kSteps; ++n) {
      attn::store(op + 8 * n, o[n][2 * r] / den);
      attn::store(op + 8 * n + 1, o[n][2 * r + 1] / den);
    }
  }
}

template <class T>
bool aligned16(const T* p, const Strides& s) {
  constexpr long long kVec = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % kVec == 0 &&
         s.s % kVec == 0 && s.h % kVec == 0;
}

template <class T, int D, int kGroups, bool kLse>
int launch(const T* q, const T* k, const T* v, T* out, const Strides& qs,
           const Strides& ks, const Strides& vs, int b, int sq, int skv,
           int h, int kh, int causal, int window, float scale, float* lse,
           cudaStream_t stream) {
  using Ly = Layout<T, D, kGroups>;
  const auto kernel = flash_fwd<T, D, kGroups, kLse>;
  // the opt-in holds for the current device only, so it is set on every
  // launch that needs it (a cheap host call), never cached
  if (Ly::kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly::kBytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset it, so the next launch does not report it
      return (int)err;
    }
  }
  const int vec = aligned16(k, ks) && aligned16(v, vs);
  const Strides os{(long long)sq * h * D, (long long)h * D, D};
  const dim3 grid((sq + Ly::kBQ - 1) / Ly::kBQ, h, b);
  kernel<<<grid, kThreads, Ly::kBytes, stream>>>(
      q, k, v, out, qs, ks, vs, os, sq, skv, h / kh, causal, window, scale,
      vec, lse);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  Strides are in elements; out is a
// contiguous (B, Sq, H, D) tensor of q's dtype.  lse, when not null (f32
// only), is a contiguous (B, H, Sq) f32 tensor that takes each row's
// log-sum-exp of its scaled, masked scores, m + log(max(l, 1e-20)) from
// the row's final (m, l) (the backward's input, flash_attention_bwd.cu);
// out is the same with or without it.  Returns a cudaError_t
// (cudaErrorInvalidValue for a head dim other than 64, 80, 128 or 256, a
// bf16 call asking for the lse, or shapes the grid cannot hold).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, long long qsb,
                               long long qss, long long qsh, long long ksb,
                               long long kss, long long ksh, long long vsb,
                               long long vss, long long vsh, int b, int sq,
                               int skv, int h, int kh, int d, int causal,
                               int window, float scale, void* lse,
                               cudaStream_t stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kh < 1 || h % kh != 0 ||
      sq < 1 || skv < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  return attn::dispatch<64, 80, 128, 256>(dtype, d, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dim)::value;
    const auto* qp = static_cast<const T*>(q);
    const auto* kp = static_cast<const T*>(k);
    const auto* vp = static_cast<const T*>(v);
    auto* op = static_cast<T*>(out);
    if (lse != nullptr) {
      if constexpr (std::is_same<T, float>::value) {
        auto* lp = static_cast<float*>(lse);
        return causal ? launch<T, D, 2, true>(qp, kp, vp, op, qs, ks, vs, b,
                                              sq, skv, h, kh, 1, window,
                                              scale, lp, stream)
                      : launch<T, D, 1, true>(qp, kp, vp, op, qs, ks, vs, b,
                                              sq, skv, h, kh, 0, window,
                                              scale, lp, stream);
      } else {
        return (int)cudaErrorInvalidValue;   // the lse is f32 only
      }
    }
    return causal ? launch<T, D, 2, false>(qp, kp, vp, op, qs, ks, vs, b, sq,
                                           skv, h, kh, 1, window, scale,
                                           nullptr, stream)
                  : launch<T, D, 1, false>(qp, kp, vp, op, qs, ks, vs, b, sq,
                                           skv, h, kh, 0, window, scale,
                                           nullptr, stream);
  });
}
