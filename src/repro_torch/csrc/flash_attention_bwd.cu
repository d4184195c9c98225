// flash_attention_bwd: the gradient of the GQA prefill attention
// (flash_attention.cu, K5) with respect to q, k and v, for Hopper (sm_90a),
// on the tensor cores in 3xTF32.
//
// Replaces: no TPU kernel.  The JAX package differentiates its plain jnp
// attention (src/repro/models/model.py, under jax.value_and_grad in
// src/repro/train/train_step.py); no Pallas kernel there has a backward.
// The port's model runs K5 in every attention layer on the card, so its
// training needs K5's gradient, and this kernel is it (bound through a
// torch.autograd.Function in kernels/flash_attention/ops.py).
//
// Contract (the plain version, kernels/flash_attention/ref.py::
// flash_attention_bwd_ref): contiguous q, dout (B, Sq, H, D), k, v (B, Skv,
// KH, D), all f32 or all bf16, and the f32 out (B, Sq, H, D) and lse (B, H,
// Sq) that K5 writes when asked for the lse (out before any rounding).  With S = (q . k) * D^-0.5 under K5's masks (causal keeps
// k <= q, a window > 0 keeps k > q - window, positions from 0 for q and
// k):
//   P = exp(S - lse) where the mask keeps (i, j), else 0 -- but a row with
//       no valid key at all (a window and q >= Skv + window - 1) has the
//       uniform P = 1 / Skv that K5's -1e30 masked scores give it;
//   dV = P^T dO, dP = dO V^T, Di = rowsum(dO o O), dS = P o (dP - Di) where
//   the mask keeps (i, j), else 0 (the masked scores are constants);
//   dQ = dS K D^-0.5, dK = dS^T Q D^-0.5,
// dK and dV summed over the H / KH query heads of each kv head.  dq, dk,
// dv are written contiguous, in the layouts and the dtype of q and k.  Head
// dims 64, 80, 128 and 256, H % KH == 0.
//
// bf16 (the training path under compute_dtype=bfloat16): the f32 gradient
// of the widened inputs, rounded once to bf16 at the store, which is what
// jax.grad of the reference's bf16 attention gives (it computes in f32 on
// widened operands and rounds its output; under GQA it also rounds each
// query head's share of dK and dV before their bf16 sum, where this sums
// in f32).  The one choice: Di is taken from K5's f32 output, before its
// rounding to bf16, as the reference differentiates through its f32
// output.  FlashAttention-2's form, Di from the bf16 output, moves Di by up
// to 2^-8 sum_d |dO_d O_d| a row (bf16's unit roundoff);
// tests/test_torch_bf16_train.py measures what that costs the plain
// version against jax.grad: 1.7e-3 to 2.0e-3 relative in dq and dk, where
// the f32 output gives 1e-5 to 3e-5.  A bf16 operand widens exactly into TF32 (its lo part is 0), so
// the lo products of bf16 operands are not issued: S, dP (bf16 x bf16) take
// one product, hi.hi; dV, dK, dQ (P or dS in f32 x bf16) two, lo.hi +
// hi.hi.  Every product and sum is then the f32 entry's on the widened
// inputs (the skipped products add exact zeros), so a bf16 call gives the
// f32 entry's result on the widened inputs, rounded.  The bf16 rows a block
// keeps (K, V in dkv; Q, dO in dq) are widened into the same f32 tiles by
// plain loads; the streamed tiles are copied raw in bf16 by cp.async and
// widened into (hi, 0) pairs by the split pass; the shared memory layout is
// the f32 entries'.
//
// What bounds it on this card: the operations.  At stablelm-1.6b's
// training shape (1, 4096, 32, 64) causal, the five products (S, dP, dV,
// dK, dQ) are 1.718e11 FLOP under the mask, 1.04146 ms at the 165 TFLOP/s
// the tensor cores give at f32 accuracy (3xTF32: a third of their 495 in
// TF32), against 0.0803 ms for the 269 MB that must cross HBM (q, k, v,
// dout, lse read and dq, dk, dv written once).  This kernel issues seven
// products (S and dP again in the dQ pass; the tiles on the diagonal
// whole): 2.44e11 FLOP, a floor of 1.48 ms at 165 TFLOP/s.  A five-product
// form would need dQ summed across blocks in one fixed order.
//
// Design.  Three launches, no atomics, so every sum runs in one order fixed
// by the element's own row, head and the masks, whatever B or the block's
// place in the grid: two calls give the same bits, and a batch gives
// bitwise the result of its elements run one at a time.
//   1. prep: Di for every row, one warp a row, a fixed butterfly.
//   2. dkv: a block per (kv head, batch, KV tile of kBK keys), four warps,
//      each owning 16 keys (but see wide heads below), walks the H / KH query heads of its group and,
//      for each, the q tiles of kBQ rows that the masks leave anything in
//      (and those holding rows with no valid key).  Per q tile a warp forms
//      S^T = K Q^T and dP^T = V dO^T (its keys x the tile's rows) in the
//      mma accumulators, P^T and dS^T in place, and adds P^T dO to dV and
//      dS^T Q to dK, both held in registers for the whole walk.
//   3. dq: a block per (head, batch, q tile of kBQ rows), four warps of 16
//      rows (but see wide heads), walks the KV tiles of kBK keys in its causal / window range,
//      forms S = Q K^T and dP = dO V^T, dS in place, and adds dS K to dQ
//      in registers.
// Every product is mma.sync m16n8k8 in TF32, each f32 operand split into a
// hi and a lo part (attention_common.cuh's split: the same hi / lo as K5)
// and summed lo.hi + hi.lo + hi.hi, small terms first (3xTF32).  The
// accumulator of S^T (dP^T) is the A operand of P^T dO (dS^T Q) once each
// 8-row slice is relabelled (A column t <-> row 2t, t + 4 <-> 2t + 1, K5's
// relabelling), with dO's and Q's rows read in that order; likewise dS is
// the A operand of dS K: no shuffle, and P and dS never touch shared
// memory.  Splits, each once: the streamed tile (Q, dO in dkv; K, V in dq)
// is read by all four warps, so it is split once a step by the whole block
// into hi / lo pairs in shared memory (8 bytes an element, swizzled so
// that both read patterns, (row g, dim t) and (row 2t, dim g), are free of
// bank conflicts); a warp's fixed rows (K, V in dkv; Q, dO in dq) stay f32,
// and each A fragment is split once a dim step and used for the whole
// tile; P^T, dS^T and dS are split once an 8-row slice and used for every
// dim slice.  The tensor core's f32 sums round toward zero, so the running
// dK, dV and dQ take each tile's products summed from zero and then added
// in f32 (a 4,096-row walk fed straight into them drifted 4.5e-5).  The
// streamed tiles are copied raw by cp.async (16 bytes a thread, zero-filled
// past Sq / Skv; lse and Di 4 bytes a row, two stages) while the block
// works on the last one; the fixed rows come with the first.  Rows of f32
// tiles are padded to D + 4 floats: an A fragment read hits 32 banks.
// exp is ex2.approx of the score times D^-0.5 log2(e) less lse log2(e).
//
// Layout per head dim (tiles, shared memory bytes, blocks an SM as shared
// memory allows; the registers, at most 255 a thread, allow two):
//           dkv: keys x q rows a step          dq: q rows x keys a step
//   D = 64:  64 x 32,  84,480, 2                64 x 32,  83,968, 2
//   D = 80:  64 x 32, 104,960, 2                64 x 32, 104,448, 2
//   D = 128: 32 x 16,  83,200, 2                64 x 32, 165,888, 1
//   D = 256: 32 x 8,  115,840, 1                32 x 16, 164,864, 1
// Wide heads: dK and dV of 16 keys take D floats a thread, dQ of 16 rows
// D / 2; beside S^T, dP^T, the partial sums, the split fragments and
// addresses, dK / dV at D = 128 and 256 and dQ at 256 went past the 255
// registers a thread may hold (ptxas spilled).  So there two warps share
// each 16 keys (rows) and split D: each forms the whole S^T and dP^T (S,
// dP) of its keys (rows), the same operations in the same order, so the
// same values, and accumulates its half of the dims.  Those passes issue
// their first two products twice.  D = 256's dK / dV still spilled at 16
// q rows a step; at 8 it does not.
//
// Long blocks first: under the causal mask the KV tile index is
// blockIdx.z (tile 0 walks every q tile) and the q tile index is the
// last minus blockIdx.z (the last q tile walks every KV tile), so the
// blocks launched first are those that take longest.
//
// mma.sync and not wgmma: TF32 wgmma takes both operands K-major from
// shared memory (A may come from registers), so dV = P^T dO, dK = dS^T Q
// and dQ = dS K would need dO, Q and K transposed in shared memory beside
// their hi / lo tiles, past the shared memory that two blocks an SM leave.
//
// What held the first kernel (CUDA-core f32, 11.65 ms at the training
// shape, 2.1x SDPA's f32 backward) back, and what this one does: its
// products ran as scalar FMAs from shared memory at a third of the CUDA
// cores' 67 TFLOP/s (here: mma.sync, whose 3xTF32 peak is 165); its loads
// were synchronous behind a barrier (here: cp.async under the products);
// P and dS made a round trip through shared memory (here: accumulator
// relabelling).
#include "attention_common.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::kFull;
using attn::mma3;
using attn::split;

constexpr int kThreads = 128;   // four warps
constexpr int kWarps = kThreads / 32;

// The dK / dV pass: kSplit warps share each 16 keys (each a part of D);
// the block holds kBK keys of K and V (f32, rows padded to kP floats), and
// takes kBQ rows of Q and dO a step: copied raw, then split into hi / lo
// tiles.  Shared memory, in floats: K, V; raw Q, dO; split Q, dO; lse and
// Di, two stages.
template <int D>
struct KvLayout {
  static constexpr int kSplit = D > 80 ? 2 : 1;
  static constexpr int kBK = 16 * kWarps / kSplit;
  static constexpr int kBQ = D > 128 ? 8 : D > 80 ? 16 : 32;
  static constexpr int kP = D + 4;
  static constexpr int kC = D == 80 ? 10 : D == 64 ? 8 : 4;   // see add_tile
  static constexpr int kRaw = 2 * kBK * kP;
  static constexpr int kSplitAt = kRaw + 2 * kBQ * D;
  static constexpr int kRowsAt = kSplitAt + 4 * kBQ * D;
  static constexpr int kBytes = (kRowsAt + 4 * kBQ) * 4;
};

// The dQ pass: kSplit warps share each 16 query rows (each a part of D);
// the block holds kBQ rows of Q and dO (f32, padded), and takes kBK rows
// of K and V a step, raw then split.  Shared memory: Q, dO; raw K, V;
// split K, V.
template <int D>
struct QLayout {
  static constexpr int kSplit = D > 128 ? 2 : 1;
  static constexpr int kBQ = 16 * kWarps / kSplit;
  static constexpr int kBK = D > 128 ? 16 : 32;
  static constexpr int kP = D + 4;
  static constexpr int kC = D == 80 ? 10 : D == 64 ? 8 : 4;
  static constexpr int kRaw = 2 * kBQ * kP;
  static constexpr int kSplitAt = kRaw + 2 * kBK * D;
  static constexpr int kBytes = (kSplitAt + 4 * kBK * D) * 4;
};

// one 4-byte copy from global to shared memory (zero-filled unless valid)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// rows r0 .. r0 + kRows - 1 of a (rows, ld) matrix of T into dst (pitch
// kPitch elements of T) by cp.async, rows at or past ``limit`` as zeros
template <int D, int kRows, int kPitch, class T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long ld, int r0, int limit) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kChunks = D / kVec;   // 16-byte copies a row
  constexpr int kCopies = kRows * kChunks;
#pragma unroll
  for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (kCopies % kThreads != 0 && c >= kCopies) break;
    const int r = c / kChunks, e = (c - r * kChunks) * kVec;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * kPitch + e,
               src + (ok ? (long long)(r0 + r) * ld : 0) + e, ok);
  }
}

// A block's fixed rows (kRows of D, pitch kPitch floats) as f32: f32 rows
// by cp.async (stage_rows), bf16 rows widened by plain loads (exact), each
// visible to the block after its next barrier
template <int D, int kRows, int kPitch, class T>
__device__ __forceinline__ void stage_fixed(float* dst, const T* src,
                                            long long ld, int r0,
                                            int limit) {
  if constexpr (std::is_same<T, float>::value) {
    stage_rows<D, kRows, kPitch>(dst, src, ld, r0, limit);
  } else {
    for (int i = threadIdx.x; i < kRows * D / 2; i += kThreads) {
      const int r = i / (D / 2), c = (i - r * (D / 2)) * 2;
      const float2 x = r0 + r < limit
          ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                src + (long long)(r0 + r) * ld + c))
          : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(dst + r * kPitch + c) = x;
    }
  }
}

// Where element (r, c) of a split tile of D columns lies, in float2 (hi,
// lo) pairs: row r, column c with bits 2-3 XORed by a function of r mod 8
// that is one-to-one on rows {0..3}, {4..7}, {0, 2, 4, 6} and {1, 3, 5,
// 7}.  The two read patterns, (row 8j + g, column 8s + t) and (row 8j + 2t
// (+1), column 8n + g), then hit 16 distinct 8-byte bank pairs in each
// half-warp; the split keeps 4-column groups together (16-byte aligned).
__device__ __forceinline__ int swz_of(int r) {
  return (((r >> 1) & 3) ^ ((r & 1) << 1)) << 2;
}
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + (c ^ swz_of(r));
}

// four elements of a raw tile as f32
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The raw (kRows, D) tiles of two tensors into their split tiles: every
// element x as (hi, lo), x = hi + lo (attention_common.cuh's split; a bf16
// element widens exactly into TF32: hi = x, lo = 0)
template <int D, int kRows, class T>
__device__ __forceinline__ void split_tiles(const T* raw, float2* out) {
  constexpr int kN = 2 * kRows * D / 4;   // 4-element groups, both tensors
#pragma unroll 4
  for (int i = threadIdx.x; i < kN; i += kThreads) {
    const int m = i / (kRows * D / 4), rest = i - m * (kRows * D / 4);
    const int r = rest / (D / 4), c = (rest - r * (D / 4)) * 4;
    const float4 x = widen4(raw + 4 * i);
    uint32_t h[4], l[4];
    if constexpr (std::is_same<T, float>::value) {
      split(x.x, h[0], l[0]);
      split(x.y, h[1], l[1]);
      split(x.z, h[2], l[2]);
      split(x.w, h[3], l[3]);
    } else {
      h[0] = __float_as_uint(x.x), h[1] = __float_as_uint(x.y);
      h[2] = __float_as_uint(x.z), h[3] = __float_as_uint(x.w);
      l[0] = l[1] = l[2] = l[3] = 0u;
    }
    float4* o = reinterpret_cast<float4*>(out + m * kRows * D + swz<D>(r, c));
    o[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(l[0]),
                       __uint_as_float(h[1]), __uint_as_float(l[1]));
    o[1] = make_float4(__uint_as_float(h[2]), __uint_as_float(l[2]),
                       __uint_as_float(h[3]), __uint_as_float(l[3]));
  }
}

// the hi and lo parts of two (hi, lo) pairs of a split tile
__device__ __forceinline__ void unpair(float2 x0, float2 x1, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  hi[0] = __float_as_uint(x0.x);
  hi[1] = __float_as_uint(x1.x);
  lo[0] = __float_as_uint(x0.y);
  lo[1] = __float_as_uint(x1.y);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (ex2.approx: relative error ~2^-22, far inside the checks' 1e-4)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool keeps(int i, int j, int causal, int window) {
  return (!causal || j <= i) && (window <= 0 || j > i - window);
}

// A fragment of 16 rows of an f32 tile at dims 8s .. 8s + 7 (row g, dim
// t and so on), split: ``p`` points at (row g, dim t) of step 0.  kExact:
// the rows are widened bf16, exact in TF32, so hi is the value (lo unset,
// never read)
template <int kP, bool kExact>
__device__ __forceinline__ void split_rows(const float* p, int s,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  if constexpr (kExact) {
    hi[0] = __float_as_uint(p[8 * s]);
    hi[1] = __float_as_uint(p[8 * kP + 8 * s]);
    hi[2] = __float_as_uint(p[8 * s + 4]);
    hi[3] = __float_as_uint(p[8 * kP + 8 * s + 4]);
  } else {
    split(p[8 * s], hi[0], lo[0]);
    split(p[8 * kP + 8 * s], hi[1], lo[1]);
    split(p[8 * s + 4], hi[2], lo[2]);
    split(p[8 * kP + 8 * s + 4], hi[3], lo[3]);
  }
}

// Two products of one shape at once: c[j] += (16 rows at ``a``) . (rows
// 8j .. 8j + 7 of the split tile ``b``)^T over D, and d[j] the same of
// ``a2`` and ``b2``: S^T = K Q^T with dP^T = V dO^T, S = Q K^T with dP =
// dO V^T.  Each A fragment is split once a dim step and used for every j.
// Row 8j + g of a split tile has the swizzle of g, so column 8s + t + 4u
// lies at 8s + off[s & 1][u]; steps go in pairs, so s & 1 is known.
// kExact (bf16 operands, both sides exact in TF32): one product, hi.hi.
template <int D, int kJ, int kP, bool kExact>
__device__ __forceinline__ void row_products(float (&c)[kJ][4],
                                             float (&d)[kJ][4],
                                             const float* a, const float* a2,
                                             const float2* b,
                                             const float2* b2) {
  constexpr int kUnroll = D <= 80 ? D / 16 : 2;   // pairs of steps
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int x = swz_of(g);
  int off[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int u = 0; u < 2; ++u) off[p][u] = ((8 * p + t + 4 * u) ^ x) - 8 * p;
  const float2* const br = b + g * D;
  const float2* const br2 = b2 + g * D;
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = d[j][e] = 0.f;
#pragma unroll kUnroll
  for (int s2 = 0; s2 < D / 16; ++s2) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int s = 2 * s2 + p;
      uint32_t ah[4], al[4], a2h[4], a2l[4];
      split_rows<kP, kExact>(a, s, ah, al);
      split_rows<kP, kExact>(a2, s, a2h, a2l);
      const int o0 = 8 * s + off[p][0], o1 = 8 * s + off[p][1];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {   // B: row 8j + g, dims 8s + t, + 4
        uint32_t xh[2], xl[2], yh[2], yl[2];
        unpair(br[8 * j * D + o0], br[8 * j * D + o1], xh, xl);
        unpair(br2[8 * j * D + o0], br2[8 * j * D + o1], yh, yl);
        if constexpr (kExact) {
          attn::mma(c[j], ah, xh);
          attn::mma(d[j], a2h, yh);
        } else {
          mma3(c[j], ah, al, xh, xl);
          mma3(d[j], a2h, a2l, yh, yl);
        }
      }
    }
  }
}

// An accumulator slice as the next product's A operand, relabelled
// (column t <-> row 2t, t + 4 <-> 2t + 1), split
__device__ __forceinline__ void split_acc(const float (&c)[4],
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// acc += A . B over one tile: A the kJ relabelled accumulator slices ``a``
// (rows 8j + 2t, 8j + 2t + 1 of the tile), B the split tile ``b`` (slice
// n at columns d0 + 8n + g).  The tensor core's f32 sums round toward
// zero, so a running sum fed by thousands of products drifts (4.5e-5
// relative at 4,096 rows): each tile is summed from zero, kC dim slices at
// a time, and then added to ``acc`` in f32.  kExact: B is widened bf16
// (lo 0), so its lo product is not issued (attention_common.cuh's mma2).
template <int D, int kN, int kC, int kJ, bool kExact>
__device__ __forceinline__ void add_tile(float (&acc)[kN][4],
                                         const float (&a)[kJ][4],
                                         const float2* b, int d0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // rows 2t + v of a slice have the swizzle of 2t + v: column d0 + 8n + g
  // lies at d0 + 8n + off[v][n & 1]
  int off[2][2];
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      off[v][p] = ((8 * p + g) ^ swz_of(2 * t + v)) - 8 * p;
  const float2* const r0 = b + 2 * t * D + d0;
  const float2* const r1 = r0 + D;
#pragma unroll
  for (int c0 = 0; c0 < kN; c0 += kC) {
    float part[kC][4];
#pragma unroll
    for (int n = 0; n < kC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      uint32_t ah[4], al[4];
      split_acc(a[j], ah, al);
#pragma unroll
      for (int n = 0; n < kC; ++n) {
        const int o = 8 * j * D + 8 * (c0 + n);
        uint32_t bh[2], bl[2];
        unpair(r0[o + off[0][(c0 + n) & 1]], r1[o + off[1][(c0 + n) & 1]],
               bh, bl);
        if constexpr (kExact) {
          attn::mma2(part[n], ah, al, bh);
        } else {
          mma3(part[n], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 + n][e] += part[n][e];
  }
}

// Di[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in f32, O K5's f32
// output; a warp a row
template <class T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep(const float* __restrict__ out, const T* __restrict__ dout,
               float* __restrict__ di, int rows, int sq, int h, int d) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                 // row = (b * Sq + i) * H + head
  const float* o = out + (long long)row * d;
  const T* g = dout + (long long)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32)
    s += o[c] * attn::widen(g[c]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) {
    const int head = row % h, bi = row / h, i = bi % sq, b = bi / sq;
    di[((long long)b * h + head) * sq + i] = s;
  }
}

template <class T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              T* __restrict__ dk, T* __restrict__ dv, int sq, int skv,
              int h, int kh, int causal, int window, float scale) {
  using Ly = KvLayout<D>;
  constexpr bool kExact = sizeof(T) == 2;   // bf16: exact in TF32
  constexpr int kBK = Ly::kBK, kBQ = Ly::kBQ, kP = Ly::kP;
  constexpr int kN = D / 8 / Ly::kSplit;    // a warp's 8-dim slices of dK
  constexpr int kJ = kBQ / 8;               // 8-row slices of a q tile
  extern __shared__ __align__(16) float smem[];
  float* const ks = smem;                   // kBK x kP
  float* const vs = ks + kBK * kP;
  T* const raw =                            // Q then dO, kBQ x D each
      reinterpret_cast<T*>(smem + Ly::kRaw);
  const float2* const qsp =                 // split Q then dO
      reinterpret_cast<const float2*>(smem + Ly::kSplitAt);
  const float2* const dosp = qsp + kBQ * D;
  float* const rows_at = smem + Ly::kRowsAt;   // two of lse, Di (kBQ each)
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int warp = threadIdx.x / 32;
  const int kg = warp % (kWarps / Ly::kSplit);   // its 16 keys
  const int d0 = warp / (kWarps / Ly::kSplit) * kN * 8;   // its dims
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;
  const int group = h / kh;
  const long long ldq = (long long)h * D, ldk = (long long)kh * D;
  const float inv_skv = 1.f / (float)skv;
  const float scale2 = scale * kLog2e;      // exp(x) = 2^(x log2 e)

  stage_fixed<D, kBK, kP>(ks, k + ((long long)b * skv * kh + hk) * D, ldk,
                          k0, skv);
  stage_fixed<D, kBK, kP>(vs, v + ((long long)b * skv * kh + hk) * D, ldk,
                          k0, skv);

  // the q tiles this KV tile meets: those holding rows in [lo, hi] under
  // the masks, [a0, a1), then those holding rows with no valid key at all,
  // [dead0, Sq) (only under a window), [b0, n_tiles)
  const int k_last = min(k0 + kBK, skv) - 1;
  const int lo = causal ? k0 : 0;
  const int hi = window > 0 ? min(sq - 1, k_last + window - 1) : sq - 1;
  const int dead0 = window > 0 ? skv + window - 1 : sq;
  const int n_tiles = (sq + kBQ - 1) / kBQ;
  const int a0 = lo / kBQ, a1 = lo <= hi ? hi / kBQ + 1 : a0;
  const int b0 = dead0 < sq ? max(dead0 / kBQ, a1) : n_tiles;
  const int per_head = (a1 - a0) + (n_tiles - b0);
  const int n_steps = per_head * group;
  // step i: query head hk * group + i / per_head, q tile tile_of(i)
  auto tile_of = [&](int i) {
    const int s = i % per_head;
    return s < a1 - a0 ? a0 + s : b0 + s - (a1 - a0);
  };
  auto stage_step = [&](int i) {
    const int head = hk * group + i / per_head, r0 = tile_of(i) * kBQ;
    const long long row0 = (long long)b * sq * h + head;
    stage_rows<D, kBQ, D>(raw, q + row0 * D, ldq, r0, sq);
    stage_rows<D, kBQ, D>(raw + kBQ * D, dout + row0 * D, ldq, r0, sq);
    const int row = r0 + threadIdx.x % kBQ;
    if (threadIdx.x < 2 * kBQ)
      cp_async4(rows_at + (i & 1) * 2 * kBQ + threadIdx.x,
                (threadIdx.x < kBQ ? lse : di) +
                    ((long long)b * h + head) * sq + (row < sq ? row : 0),
                row < sq);
  };

  // dK, dV as C fragments: [dim slice n][0, 1] key g, dims d0 + 8n + 2t,
  // +1; [2, 3] key g + 8
  float dka[kN][4], dva[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int key0 = kg * 16;                  // the warp's keys in the tile
  const int kj0 = k0 + key0 + g;             // its keys kj0 and kj0 + 8
  const float* const kw = ks + (key0 + g) * kP + t;
  const float* const vw = vs + (key0 + g) * kP + t;

  if (n_steps > 0) stage_step(0);
  cp_async_commit();                         // K, V and the first tile
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<0>();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    split_tiles<D, kBQ>(raw,
                        reinterpret_cast<float2*>(smem + Ly::kSplitAt));
    __syncthreads();   // the split tiles are whole, the raw ones free
    if (i + 1 < n_steps) {   // the next tile's copy runs under this one
      stage_step(i + 1);
      cp_async_commit();
    }
    const float* const ls = rows_at + (i & 1) * 2 * kBQ;
    const float* const dis = ls + kBQ;
    const int q0 = tile_of(i) * kBQ;

    // S^T = K Q^T, dP^T = V dO^T: [row slice j][0, 1] key g, rows
    // q0 + 8j + 2t, +1; [2, 3] key g + 8
    float st[kJ][4], dpt[kJ][4];
    row_products<D, kJ, kP, kExact>(st, dpt, kw, vw, qsp, dosp);

    // P^T and dS^T in place, the masks where the warp's keys and the
    // tile's rows need them
    const bool edge = kj0 - g + 15 >= skv || q0 + kBQ > sq ||
                      q0 + kBQ > dead0 ||
                      (causal && kj0 - g + 15 > q0) ||
                      (window > 0 && kj0 - g <= q0 + kBQ - 1 - window);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 d2 =
          *reinterpret_cast<const float2*>(dis + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1 ? l2.y : l2.x) * kLog2e;
        const float dv_ = e & 1 ? d2.y : d2.x;
        bool ok = true, dead = false;
        if (edge) {
          const int qi = q0 + 8 * j + 2 * t + (e & 1), kj = kj0 + 8 * (e >> 1);
          const bool live = qi < sq && kj < skv;
          ok = live && keeps(qi, kj, causal, window);
          dead = live && qi >= dead0;
        }
        const float p = ok ? ex2(fmaf(st[j][e], scale2, -lv))
                           : (dead ? inv_skv : 0.f);
        dpt[j][e] = ok ? p * (dpt[j][e] - dv_) : 0.f;
        st[j][e] = p;
      }
    }

    // dV += P^T dO, dK += dS^T Q (the warp's dims)
    add_tile<D, kN, Ly::kC, kJ, kExact>(dva, st, dosp, d0);
    add_tile<D, kN, Ly::kC, kJ, kExact>(dka, dpt, qsp, d0);
  }
  cp_async_wait<0>();   // K and V, when no step ran

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = kj0 + 8 * r;
    if (j >= skv) continue;
    const long long off =
        ((long long)b * skv + j) * ldk + (long long)hk * D + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n) {   // rounded once, for a bf16 call
      attn::store2(dk + off + 8 * n, dka[n][2 * r] * scale,
                   dka[n][2 * r + 1] * scale);
      attn::store2(dv + off + 8 * n, dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <class T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             T* __restrict__ dq, int sq, int skv, int h, int kh,
             int causal, int window, float scale) {
  using Ly = QLayout<D>;
  constexpr bool kExact = sizeof(T) == 2;   // bf16: exact in TF32
  constexpr int kBQ = Ly::kBQ, kBK = Ly::kBK, kP = Ly::kP;
  constexpr int kN = D / 8 / Ly::kSplit;    // a warp's 8-dim slices of dQ
  constexpr int kJ = kBK / 8;               // 8-key slices of a KV tile
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;                   // kBQ x kP
  float* const dos = qs + kBQ * kP;
  T* const raw =                            // K then V, kBK x D each
      reinterpret_cast<T*>(smem + Ly::kRaw);
  const float2* const ksp =                 // split K then V
      reinterpret_cast<const float2*>(smem + Ly::kSplitAt);
  const float2* const vsp = ksp + kBK * D;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int warp = threadIdx.x / 32;
  const int rg = warp % (kWarps / Ly::kSplit);   // its 16 rows
  const int d0 = warp / (kWarps / Ly::kSplit) * kN * 8;   // its dims
  const int head = blockIdx.x, b = blockIdx.y;
  const int tile = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = tile * kBQ, w0 = q0 + rg * 16;
  const int hk = head / (h / kh);
  const long long ldq = (long long)h * D, ldk = (long long)kh * D;
  const long long row0 = (long long)b * sq * h + head;
  const float scale2 = scale * kLog2e;      // exp(x) = 2^(x log2 e)

  stage_fixed<D, kBQ, kP>(qs, q + row0 * D, ldq, q0, sq);
  stage_fixed<D, kBQ, kP>(dos, dout + row0 * D, ldq, q0, sq);

  // the keys the tile's rows may attend (rows with none get dS = 0)
  const int q1 = min(q0 + kBQ, sq) - 1;
  const int jlo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int jhi = causal ? min(q1, skv - 1) : skv - 1;
  const int t0 = jlo / kBK;
  const int n_steps = jlo <= jhi ? jhi / kBK - t0 + 1 : 0;
  const T* const kb = k + ((long long)b * skv * kh + hk) * D;
  const T* const vb = v + ((long long)b * skv * kh + hk) * D;
  auto stage_step = [&](int i) {
    stage_rows<D, kBK, D>(raw, kb, ldk, (t0 + i) * kBK, skv);
    stage_rows<D, kBK, D>(raw + kBK * D, vb, ldk, (t0 + i) * kBK, skv);
  };

  // the thread's rows w0 + g and w0 + g + 8: their lse and Di
  const int rows[2] = {w0 + g, w0 + g + 8};
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long off = ((long long)b * h + head) * sq + rows[r];
    lr[r] = rows[r] < sq ? lse[off] * kLog2e : 0.f;   // in base 2
    dr[r] = rows[r] < sq ? di[off] : 0.f;
  }
  // dQ as C fragments: [dim slice n][0, 1] row g, dims d0 + 8n + 2t, +1;
  // [2, 3] row g + 8
  float dqa[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  const float* const qw = qs + (rg * 16 + g) * kP + t;
  const float* const dow = dos + (rg * 16 + g) * kP + t;

  if (n_steps > 0) stage_step(0);
  cp_async_commit();                         // Q, dO and the first tile
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<0>();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    split_tiles<D, kBK>(raw,
                        reinterpret_cast<float2*>(smem + Ly::kSplitAt));
    __syncthreads();   // the split tiles are whole, the raw ones free
    if (i + 1 < n_steps) {   // the next tile's copy runs under this one
      stage_step(i + 1);
      cp_async_commit();
    }
    const int kv0 = (t0 + i) * kBK;

    // S = Q K^T, dP = dO V^T: [key slice j][0, 1] row g, keys
    // kv0 + 8j + 2t, +1; [2, 3] row g + 8
    float sc[kJ][4], dp[kJ][4];
    row_products<D, kJ, kP, kExact>(sc, dp, qw, dow, ksp, vsp);

    // dS = P o (dP - Di) in place, the masks where needed
    const bool edge = kv0 + kBK > skv || w0 + 16 > sq ||
                      (causal && kv0 + kBK - 1 > w0) ||
                      (window > 0 && kv0 <= w0 + 15 - window);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (edge) {
          const int qi = rows[e >> 1], kj = kv0 + 8 * j + 2 * t + (e & 1);
          ok = qi < sq && kj < skv && keeps(qi, kj, causal, window);
        }
        dp[j][e] = ok ? ex2(fmaf(sc[j][e], scale2, -lr[e >> 1])) *
                            (dp[j][e] - dr[e >> 1])
                      : 0.f;
      }

    // dQ += dS K (the warp's dims)
    add_tile<D, kN, Ly::kC, kJ, kExact>(dqa, dp, ksp, d0);
  }
  cp_async_wait<0>();   // Q and dO, when no step ran

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    T* out = dq + ((long long)b * sq + rows[r]) * ldq +
             (long long)head * D + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n)   // rounded once, for a bf16 call
      attn::store2(out + 8 * n, dqa[n][2 * r] * scale,
                   dqa[n][2 * r + 1] * scale);
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

template <class T, int D>
int launch(const T* q, const T* k, const T* v, const float* out,
           const T* dout, const float* lse, float* di, T* dq, T* dk, T* dv,
           int b, int sq, int skv, int h, int kh, int causal, int window,
           float scale, cudaStream_t stream) {
  using Kv = KvLayout<D>;
  using Qd = QLayout<D>;
  const long long rows = (long long)b * sq * h;
  const long long kv_tiles = (skv + Kv::kBK - 1) / Kv::kBK;
  const long long q_tiles = (sq + Qd::kBQ - 1) / Qd::kBQ;
  if (rows > 0x7fffffffLL / 2 || kv_tiles > 65535 || q_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  flash_bwd_prep<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads,
                      0, stream>>>(out, dout, di, (int)rows, sq, h, D);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if ((err = set_smem(flash_bwd_dkv<T, D>, Kv::kBytes))) return err;
  flash_bwd_dkv<T, D><<<dim3(kh, b, (unsigned)kv_tiles), kThreads,
                        Kv::kBytes, stream>>>(q, k, v, dout, lse, di, dk, dv,
                                              sq, skv, h, kh, causal, window,
                                              scale);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(flash_bwd_dq<T, D>, Qd::kBytes))) return err;
  flash_bwd_dq<T, D><<<dim3(h, b, (unsigned)q_tiles), kThreads, Qd::kBytes,
                       stream>>>(q, k, v, dout, lse, di, dq, sq, skv, h, kh,
                                 causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16, of q, k, v, dout, dq, dk and dv; out, lse
// and the scratch di are f32.  Every tensor is contiguous: q, out, dout, dq
// (B, Sq, H, D); k, v, dk, dv (B, Skv, KH, D); lse and di (B, H, Sq).  q,
// k, v and dout start at a multiple of 16 bytes (cp.async).  Returns a
// cudaError_t (cudaErrorInvalidValue for a dtype code other than 0 or 1, a
// head dim other than 64, 80, 128 or 256, or shapes the grid cannot hold).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* di, void* dq, void* dk, void* dv,
                                   int b, int sq, int skv, int h, int kh,
                                   int d, int causal, int window, float scale,
                                   cudaStream_t stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kh < 1 || h % kh != 0 ||
      sq < 1 || skv < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
      16)
    return (int)cudaErrorInvalidValue;
  return attn::dispatch<64, 80, 128, 256>(dtype, d, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dim)::value;
    return launch<T, D>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(out),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(di), static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), b, sq, skv, h, kh, causal, window, scale,
        stream);
  });
}
