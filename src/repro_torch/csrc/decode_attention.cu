// decode_attention / decode_attention_q8: one query token per sequence
// against its KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:86
// decode_attention_pallas (K6, pallas_call at :99) and :122
// decode_attention_pallas_q8 (K7, pallas_call at :136), the TPU kernels
// that stream the cache through VMEM in 512-row blocks along a sequential
// grid axis, carrying (m, l, acc) in scratch, through one _kernel_body.
// K7 reads an int8 cache with an f32 scale per (token, kv head) and
// dequantizes each element right after its load.
//
// Contract (the plain versions, kernels/decode_attention/ref.py): q (B, 1,
// H, D), f32 or bf16; k / v cache (B, Smax, KH, D), H % KH == 0, of q's
// dtype (K6) or int8 with scales (B, Smax, KH, 1) f32 (K7), all read in
// place through their strides (the head dim contiguous); per-slot lengths
// len[b] >= 1 (a (B,) int32 array, or one value for every slot).  Position
// j of slot b is valid when j < len[b] and, with a window > 0, j > len[b] -
// 1 - window; a length >= Smax makes every slot position valid (ring
// buffers).  K7's elements are k = float(k_q) * k_scale (one f32 rounding,
// as the plain version's dequantize), then both compute the same: scores
// (q * D^-0.5) . k in f32; out = sum_j p_j v_j / max(l, 1e-20) over the
// valid positions, in q's dtype.  If a window leaves no valid position
// (len - window >= Smax), the row is the mean of every V, as the plain
// softmax over all-masked (-1e30) scores gives it.
//
// What bounds it on this card: bytes.  Each valid K and V row is read once
// (int8: D + 4 bytes with its scale).  At a long cache -- 4,096 rows of 32
// kv heads x 80 in f32, 84 MB -- that is 0.025 ms at HBM's 3.35 TB/s, which
// only rows in flight on every SM can reach: one block per (kv head, slot),
// as the kernel before this design had it, put 32 blocks on 132 SMs, each
// walking its rows one after another.  At the main path's length (1 slot,
// 32 kv heads, <= 144 rows: 2.9 MB in f32, 0.7 MB in int8) the bytes take
// under 1 us at HBM's rate, and latency sets the time: the launch, an SM's
// rate of drawing its rows, the block's reductions and the merge's round
// trips through L2.  At gemma3-12b's decode (16 query heads over 8 kv heads
// of 256, f32) a 1,024-row ring is 16.8 MB of K and V, 0.0050 ms, and a
// 2,064-row global cache at most 33.8 MB, 0.0101 ms.
//
// Design.  One body, decode_fwd, templated on a row loader (FpRows: f32 /
// bf16 rows; Q8Rows: int8 rows and their scales), as the TPU kernels share
// _kernel_body.
//   1. Split-K.  Cache positions are cut into chunks of chunk_rows(Smax)
//      rows -- a function of Smax alone, so a slot's split depends neither
//      on B nor on the other slots, and K6 and K7 cut a cache alike.  A
//      block of 128 threads per (chunk, kv head, slot); a chunk with no
//      valid position returns at once.  The main path's 129-144 rows x 32
//      kv heads give 160 blocks; 4,096 rows give 2,048.
//   2. Staging.  The chunk's valid K and V rows are all issued at once as
//      16-byte cp.async copies, neighbouring threads on neighbouring
//      addresses (K7's scales load beside them), into rows padded so that
//      a score's reads hit distinct banks (row_pitch).  A cache whose
//      address or strides are not multiples of 16 bytes is staged into the
//      same rows by plain element loads.  Up to 8 query heads of the kv
//      head's group are served per pass from the one staged copy, so each
//      K / V row is read once per kv head.
//   3. A chunk's softmax.  Each warp takes a quarter of the chunk's rows, 8
//      a round, four lanes a row, so its rows' scores are independent
//      chains: a lane takes the quads of four elements sub, sub + 4, ... of
//      D, one FMA chain per element of a quad in ascending d, then (c0 +
//      c1) + (c2 + c3), and two xor shuffles sum the row's four lanes.  K7
//      widens each element as float(k_q) * scale (one f32 rounding) before
//      the same arithmetic, so it gives K6's bits on the dequantized cache.
//      The warp's max, p = exp(s - m) and l over its rows come from xor
//      shuffles, its P.V from a lane per quad of D over its rows (two quads
//      a lane at D = 256); the four warps' (m, l, acc) are merged in warp
//      order.  At D = 256 in f32 a 64-row chunk stages 139 KB of K and V,
//      past the default 48 KB (the launch opts in) and one block an SM.
//   4. The merge, in the same launch.  A slot whose valid positions lie in
//      one chunk is written by that chunk's block.  Otherwise every block
//      writes its partial (m, l, acc[D]) per head and then takes a ticket
//      from its (slot, kv head)'s counter (acq_rel, ticket.cuh); the last
//      block merges the partials in chunk order, their loads in flight 16
//      at a time, and sets the counter back to 0 (the caller keeps one
//      zeroed array per (card, stream)).  The order is fixed, so which
//      block merges changes no bit, and a batch equals its slots run one at
//      a time, bitwise.  With no valid position every row scores -1e30, p
//      = 1, and the merge gives the mean of every V.
#include <algorithm>

#include "attention_common.cuh"
#include "stamps.cuh"   // STAMP(k): phase stamps with -DKERNEL_STAMPS
#include "ticket.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::kFull;
using attn::kNegInf;
using attn::store;
using attn::Strides;
using attn::widen;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupPass = 8;   // query heads served per pass over a chunk
constexpr int kPartHead = 4;    // floats before acc[D] in a partial: m, l
constexpr int kMergeBatch = 16; // partials a merging thread loads at once
constexpr int kMaxRounds = 2;   // rounds of 8 rows a warp (64-row chunks)

// Rows of a chunk: 32 while Smax <= 1,024, else 64 (so a long cache gives
// fewer partials to merge); at most 4 warps x kMaxRounds x 8.  Smax alone
// decides it (file note, 1.).
int chunk_rows(int smax) { return smax <= 1024 ? 32 : 64; }

// Bytes of one staged row of D elements of E.  A score reads four elements
// a lane, the four lanes of a row side by side (4 * sizeof(E) words), the
// rows of a shared-memory phase (8 int8, 4 bf16 or 2 f32 rows) at one
// offset: a pitch that is an odd multiple of that width in words puts
// them in distinct banks.
template <class E, int D>
__host__ __device__ constexpr int row_pitch() {
  constexpr int width = 4 * (int)sizeof(E), words = D * (int)sizeof(E) / 4;
  return 4 * ((words / width) % 2 ? words : words + width);
}

template <class E>
bool aligned16(const E* p, Strides s) {
  const auto ok = [](long long x) {
    return x * (long long)sizeof(E) % 16 == 0;
  };
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ok(s.b) && ok(s.s) &&
         ok(s.h);
}

// Rows of an f32 / bf16 cache.
template <class C>
struct FpRows {
  using Elem = C;
  static constexpr bool kScaled = false;
  const C* p;
  Strides s;
  __device__ const C* row(int b, int hk, int j) const {
    return p + b * s.b + hk * s.h + (long long)j * s.s;
  }
  bool aligned() const { return aligned16(p, s); }
};

// Rows of an int8 cache with one f32 scale per (token, kv head) (strides
// ss); an element is float(k_q) * scale.
struct Q8Rows {
  using Elem = int8_t;
  static constexpr bool kScaled = true;
  const int8_t* p;
  const float* sc;
  Strides s, ss;
  __device__ const int8_t* row(int b, int hk, int j) const {
    return p + b * s.b + hk * s.h + (long long)j * s.s;
  }
  __device__ float scale(int b, int hk, int j) const {
    return sc[b * ss.b + hk * ss.h + (long long)j * ss.s];
  }
  bool aligned() const { return aligned16(p, s); }
};

// Four elements of a staged row, widened to f32.
__device__ __forceinline__ float4 widen4(const float* r) {
  return *reinterpret_cast<const float4*>(r);
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* r) {
  const uint2 u = *reinterpret_cast<const uint2*>(r);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 widen4(const int8_t* r) {
  const char4 c = *reinterpret_cast<const char4*>(r);
  return make_float4(c.x, c.y, c.z, c.w);
}

// Issues the copies of the chunk's rows j0 .. j1 - 1 (cache positions c0 +
// j) into staged rows j of dst: 16-byte cp.async when vec, else plain
// element loads.
template <int D, class Rows>
__device__ __forceinline__ void stage(unsigned char* dst, const Rows& rows,
                                      int b, int hk, int c0, int j0, int j1,
                                      bool vec) {
  using E = typename Rows::Elem;
  constexpr int kPitch = row_pitch<E, D>();
  constexpr int kPieces = D * (int)sizeof(E) / 16;
  const int n = j1 - j0;
  if (vec) {
    for (int i = threadIdx.x; i < n * kPieces; i += kThreads) {
      const int r = i / kPieces, e = i - r * kPieces;
      cp_async16(dst + (j0 + r) * kPitch + e * 16,
                 reinterpret_cast<const unsigned char*>(
                     rows.row(b, hk, c0 + j0 + r)) + e * 16, true);
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int r = i / D, e = i - r * D;
      reinterpret_cast<E*>(dst + (j0 + r) * kPitch)[e] =
          rows.row(b, hk, c0 + j0 + r)[e];
    }
  }
}

// Dynamic shared memory of a block: the staged K and V rows, K7's scales,
// then (f32) q of one pass's heads, their weights, and each warp's (acc[D],
// m, l) per head.
template <class Rows, int D>
size_t smem_bytes(int chunk, int gmax) {
  using E = typename Rows::Elem;
  return (size_t)2 * chunk * row_pitch<E, D>() +
         (Rows::kScaled ? 2 * chunk * 4 : 0) +
         4 * ((size_t)gmax * (D + chunk) + kWarps * gmax * (D + 2));
}

// Four blocks an SM: up to 128 registers a thread, which every entry
// fits without spilling (the default allocation spilled some).  At D = 256
// shared memory allows one or two blocks an SM, so two: up to 255.
template <class T, int D, class Rows>
__global__ void __launch_bounds__(kThreads, (D > 128 ? 2 : 4))
decode_fwd(const T* __restrict__ q, Rows kc, Rows vc, T* __restrict__ out,
           Strides qs, const int* __restrict__ lens, int len_all, int smax,
           int h, int group, int window, float scale, int chunk, int vec,
           float* __restrict__ part, int* __restrict__ tickets) {
  using E = typename Rows::Elem;
  constexpr int kPitch = row_pitch<E, D>();
  constexpr int kQuads = D / 4;             // four elements of D
  constexpr int kQuadsLane = kQuads / 4;    // a lane's, in a score
  constexpr int kLaneQuads = (kQuads + 31) / 32;  // a lane's, in P.V
  constexpr int kPart = kPartHead + D;      // floats of a partial
  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lens ? lens[b] : len_all;
  int lo = window > 0 ? max(0, len - window) : 0, hi = min(len, smax);
  const bool none = lo >= hi;  // nothing valid: every score is masked
  if (none) lo = 0, hi = smax;
  const int c0 = c * chunk;
  const int j0 = max(lo - c0, 0), j1 = min(hi - c0, chunk);
  if (j0 >= j1) return;
  STAMP(0);
  STAMP_SM();
  const int first = lo / chunk, nparts = (hi - 1) / chunk - first + 1;
  const int gmax = min(group, kGroupPass);
  const int rows_w = chunk / kWarps;        // a warp's rows, 8 a round
  int* counter = tickets + (long long)b * gridDim.y + hk;
  __shared__ int last;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem;
  unsigned char* vs = ks + chunk * kPitch;
  float* scl = reinterpret_cast<float*>(vs + chunk * kPitch);  // K, V
  float* qsm = scl + (Rows::kScaled ? 2 * chunk : 0);  // (head, D)
  float* psm = qsm + gmax * D;                         // (head, row)
  float* wacc = psm + gmax * chunk;                    // (warp, head, D)
  float* wm = wacc + kWarps * gmax * D;
  float* wl = wm + kWarps * gmax;

  stage<D>(ks, kc, b, hk, c0, j0, j1, vec);
  stage<D>(vs, vc, b, hk, c0, j0, j1, vec);
  cp_async_commit();
  if constexpr (Rows::kScaled) {
    for (int j = j0 + tid; j < j1; j += kThreads) {
      scl[j] = kc.scale(b, hk, c0 + j);
      scl[chunk + j] = vc.scale(b, hk, c0 + j);
    }
  }
  const int jw0 = max(warp * rows_w, j0);  // the warp's valid rows
  const int jw1 = min((warp + 1) * rows_w, j1);
  const long long head0 = (long long)b * h + (long long)hk * group;
  const int sub = lane & 3, rr = lane >> 2;     // a row's four lanes

  for (int g0 = 0; g0 < group; g0 += kGroupPass) {
    const int gb = min(kGroupPass, group - g0);
    for (int i = tid; i < gb * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      const long long at = b * qs.b + (hk * group + g0 + g) * qs.h + d;
      qsm[i] = widen(q[at]) * scale;
    }
    if (g0 == 0) cp_async_wait<0>();
    __syncthreads();
    STAMP(1);

    // Each warp its rows, each head: scores, softmax, P.V.
    for (int g = 0; g < gb; ++g) {
      const float4* qv = reinterpret_cast<const float4*>(qsm + g * D) + sub;
      float* pg = psm + g * chunk;
      float s[kMaxRounds], m = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxRounds; ++t) {
        const int j = warp * rows_w + 8 * t + rr;
        const bool ok = 8 * t + rr < rows_w && j >= j0 && j < j1;
        float a = 0.f;
        if (ok && !none) {
          const E* kr = reinterpret_cast<const E*>(ks + j * kPitch);
          float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int u = 0; u < kQuadsLane; ++u) {
            float4 x = widen4(kr + 4 * (sub + 4 * u));
            if constexpr (Rows::kScaled) {
              const float sk = scl[j];
              x.x = x.x * sk, x.y = x.y * sk, x.z = x.z * sk, x.w = x.w * sk;
            }
            const float4 qq = qv[4 * u];
            c4[0] = fmaf(qq.x, x.x, c4[0]), c4[1] = fmaf(qq.y, x.y, c4[1]);
            c4[2] = fmaf(qq.z, x.z, c4[2]), c4[3] = fmaf(qq.w, x.w, c4[3]);
          }
          a = (c4[0] + c4[1]) + (c4[2] + c4[3]);
        }
        a += __shfl_xor_sync(kFull, a, 1);   // the row's four lanes
        a += __shfl_xor_sync(kFull, a, 2);
        s[t] = !ok ? -INFINITY : none ? kNegInf : a;
        m = fmaxf(m, s[t]);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
      float l = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxRounds; ++t) {
        const float p = s[t] == -INFINITY ? 0.f : expf(s[t] - m);
        if (sub == 0 && 8 * t + rr < rows_w)
          pg[warp * rows_w + 8 * t + rr] = p;
        l += p;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l += __shfl_xor_sync(kFull, l, off);
      __syncwarp();
      if (lane < kQuads) {   // P.V: a lane per four elements of D, the
                             // quads lane and lane + 32 at D = 256
        float4 a[kLaneQuads];
#pragma unroll
        for (int u = 0; u < kLaneQuads; ++u)
          a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = jw0; j < jw1; ++j) {
          const float p = pg[j];
#pragma unroll
          for (int u = 0; u < kLaneQuads; ++u) {
            float4 v = widen4(reinterpret_cast<const E*>(vs + j * kPitch) +
                              4 * (lane + 32 * u));
            if constexpr (Rows::kScaled) {
              const float sv = scl[chunk + j];
              v.x = v.x * sv, v.y = v.y * sv, v.z = v.z * sv, v.w = v.w * sv;
            }
            a[u].x = fmaf(p, v.x, a[u].x), a[u].y = fmaf(p, v.y, a[u].y);
            a[u].z = fmaf(p, v.z, a[u].z), a[u].w = fmaf(p, v.w, a[u].w);
          }
        }
#pragma unroll
        for (int u = 0; u < kLaneQuads; ++u)
          *reinterpret_cast<float4*>(wacc + (warp * gmax + g) * D +
                                     4 * (lane + 32 * u)) = a[u];
      }
      if (lane == 0) wm[warp * gmax + g] = m, wl[warp * gmax + g] = l;
    }
    __syncthreads();
    STAMP(2);

    // the warps' (m, l, acc) in warp order: the output, or the chunk's
    // partial
    for (int i = tid; i < gb * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      float mm = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * gmax + g]);
      float ll = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {  // f = 0 for a warp without rows
        const float f = expf(wm[w * gmax + g] - mm);
        ll = fmaf(wl[w * gmax + g], f, ll);
        a = fmaf(wacc[(w * gmax + g) * D + d], f, a);
      }
      const long long head = head0 + g0 + g;
      if (nparts == 1) {
        store(out + head * D + d, a / fmaxf(ll, 1e-20f));
      } else {
        float* pp = part + (head * gridDim.x + c) * kPart;
        __stcg(pp + kPartHead + d, a);
        if (d == 0) {
          __stcg(pp, mm);
          __stcg(pp + 1, ll);
        }
      }
    }
    __syncthreads();  // the weights and the warps' sums serve the next pass
  }
  STAMP(3);
  if (nparts == 1) return;

  // ---- the last block of the (slot, kv head) merges ----------------------
  if (tid == 0) last = ticket::take(counter) == nparts - 1;
  __syncthreads();
  if (!last) return;
  STAMP(4);
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    const long long head = head0 + g;
    const float* pp = part + (head * gridDim.x + first) * kPart;
    float mm = -INFINITY, ll = 0.f, aa = 0.f;
    for (int k0 = 0; k0 < nparts; k0 += kMergeBatch) {
      // a batch's loads all in flight, then its partials in chunk order
      // against the batch's max, the earlier batches' sums rescaled to it
      float mk[kMergeBatch], lk[kMergeBatch], ak[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const bool ok = k0 + u < nparts;
        const float* pk = pp + (k0 + u) * kPart;
        mk[u] = ok ? __ldcg(pk) : -INFINITY;
        lk[u] = ok ? __ldcg(pk + 1) : 0.f;
        ak[u] = ok ? __ldcg(pk + kPartHead + d) : 0.f;
      }
      float m = mm;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) m = fmaxf(m, mk[u]);
      const float r = expf(mm - m);  // 0 at the first batch
      ll *= r, aa *= r;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const float f = expf(mk[u] - m);  // 0 past the last partial
        ll = fmaf(lk[u], f, ll);
        aa = fmaf(ak[u], f, aa);
      }
      mm = m;
    }
    store(out + head * D + d, aa / fmaxf(ll, 1e-20f));
  }
  if (tid == 0) *counter = 0;
  STAMP(5);
}

// floats of the partials a launch writes at most: (m, l, acc[D]) per
// (slot, query head, chunk)
long long partial_floats(int b, int smax, int h, int d) {
  const int chunk = chunk_rows(smax);
  return (long long)b * h * ((smax + chunk - 1) / chunk) * (kPartHead + d);
}
template <class T, int D, class Rows>
int launch(const void* q, Rows k, Rows v, void* out, Strides qs,
           const int* lens, int len_all, int b, int smax, int h, int kh,
           int window, float scale, int* tickets, long long ntickets,
           void* scratch, long long scratch_bytes, cudaStream_t stream) {
  if (ntickets < (long long)b * kh ||
      scratch_bytes < 4 * partial_floats(b, smax, h, D) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int chunk = chunk_rows(smax), group = h / kh;
  const size_t bytes =
      smem_bytes<Rows, D>(chunk, std::min(group, kGroupPass));
  const auto kernel = decode_fwd<T, D, Rows>;
  if (bytes > 48 * 1024) {
    // past the default 48 KB: the opt-in holds for the current card only,
    // so every such launch sets it
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset it, so the next launch does not report it
      return (int)err;
    }
  }
  kernel<<<dim3((smax + chunk - 1) / chunk, kh, b), kThreads, bytes,
           stream>>>(static_cast<const T*>(q), k, v, static_cast<T*>(out), qs,
                     lens, len_all, smax, h, group, window, scale, chunk,
                     k.aligned() && v.aligned(), static_cast<float*>(scratch),
                     tickets);
  return (int)cudaGetLastError();
}

bool bad_shapes(int b, int smax, int h, int kh, int window) {
  return b < 1 || b > 65535 || kh < 1 || kh > 65535 || h < kh ||
         h % kh != 0 || smax < 1 || window < 0;
}

}  // namespace

// Bytes of the scratch a decode_attention / decode_attention_q8 launch of
// these shapes needs (its partials); 0 for shapes the launch refuses.
extern "C" long long decode_attention_scratch_bytes(int b, int smax, int h,
                                                    int kh, int d) {
  if (bad_shapes(b, smax, h, kh, 0) || d < 1) return 0;
  return 4 * partial_floats(b, smax, h, d);
}

// dtype 0: float32, 1: bfloat16 (of q, out, and K6's cache).  q strides
// are those of its (B, H) dims (the sequence dim has one position); strides
// are in elements.  lens: (B,) int32 on the device, or null to give every
// slot len_all.  out is a contiguous (B, 1, H, D) tensor of q's dtype.
// Lengths must be >= 1 (the caller checks).  tickets: ntickets >= B * KH
// zeroed ints that no other launch uses at the same time (zero again when
// this one ends); scratch: decode_attention_scratch_bytes(...) bytes or
// more, on a 16-byte boundary.  Returns a cudaError_t
// (cudaErrorInvalidValue for a head dim other than 32, 64, 80, 128 or 256,
// or shapes the grid cannot hold).
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, void* out, long long qsb,
                                long long qsh, long long ksb, long long kss,
                                long long ksh, long long vsb, long long vss,
                                long long vsh, const int* lens, int len_all,
                                int b, int smax, int h, int kh, int d,
                                int window, float scale, int* tickets,
                                long long ntickets, void* scratch,
                                long long scratch_bytes,
                                cudaStream_t stream) {
  if (bad_shapes(b, smax, h, kh, window)) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, 0, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  return attn::dispatch<32, 64, 80, 128, 256>(dtype, d, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dim)::value;
    return launch<T, D>(q, FpRows<T>{static_cast<const T*>(k), ks},
                        FpRows<T>{static_cast<const T*>(v), vs}, out, qs,
                        lens, len_all, b, smax, h, kh, window, scale,
                        tickets, ntickets, scratch, scratch_bytes, stream);
  });
}

// K7: as decode_attention, with k / v int8 (B, Smax, KH, D) and their f32
// scales (B, Smax, KH, 1) at element strides (s*sb, s*ss, s*sh) of their
// (B, Smax, KH) dims; dtype is q's.
extern "C" int decode_attention_q8(
    int dtype, const void* q, const void* k, const void* k_scale,
    const void* v, const void* v_scale, void* out, long long qsb,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long kssb, long long ksss, long long kssh, long long vsb,
    long long vss, long long vsh, long long vssb, long long vsss,
    long long vssh, const int* lens, int len_all, int b, int smax, int h,
    int kh, int d, int window, float scale, int* tickets, long long ntickets,
    void* scratch, long long scratch_bytes, cudaStream_t stream) {
  if (bad_shapes(b, smax, h, kh, window)) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, 0, qsh};
  const Q8Rows kr{static_cast<const int8_t*>(k),
                  static_cast<const float*>(k_scale), Strides{ksb, kss, ksh},
                  Strides{kssb, ksss, kssh}};
  const Q8Rows vr{static_cast<const int8_t*>(v),
                  static_cast<const float*>(v_scale), Strides{vsb, vss, vsh},
                  Strides{vssb, vsss, vssh}};
  return attn::dispatch<32, 64, 80, 128, 256>(dtype, d, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dim)::value;
    return launch<T, D>(q, kr, vr, out, qs, lens, len_all, b, smax, h, kh,
                        window, scale, tickets, ntickets, scratch,
                        scratch_bytes, stream);
  });
}
