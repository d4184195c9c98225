// decode_attention / decode_attention_q8: one query token per sequence
// against its KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::
// decode_attention_pallas (K6) and decode_attention_pallas_q8 (K7), the TPU
// kernels that stream the cache through VMEM in 512-row blocks along a
// sequential grid axis, carrying (m, l, acc) in scratch, through one
// _kernel_body.  K7 reads an int8 cache with an f32 scale per (token, kv
// head) and dequantizes each element right after its load.
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
// Design.  One kernel body, decode_fwd, templated on a row loader (FpRows
// widens f32 / bf16; Q8Rows widens int8 and multiplies by the row's
// scale), as the TPU kernels share _kernel_body.  One block per (kv head,
// batch row), 8 warps, serving the H / KH query heads of its kv head one
// after another.  Warp w takes the valid positions lo + w, lo + w + 8, ...
// (only valid positions are read: the bytes are the valid rows of K and V,
// as the TPU kernel's block skip intends); a position's score is
// lane-strided FMAs over D and a fixed xor butterfly, then the warp's
// running (m, l, acc) takes it.  The 8 partials are merged in shared memory
// in warp order.  The split of positions among warps depends only on lo,
// so a slot's result does not depend on B: a batch equals its slots run
// one at a time, bitwise.  Since K7 dequantizes before the same
// arithmetic, it gives K6's bits on the dequantized cache.
//
// What bounds it on this card: bytes -- each valid K and V row is read
// once (int8: D + 4 bytes with its scale) -- but at the main path's shape
// (B = 1, 32 kv heads, <= 144 rows of 80, 0.7 MB in int8, 2.9 MB in f32) a
// step's launch and the warps' dependent load, shuffle and exp chain take
// longer than the 0.2-0.9 us those bytes need.  Splitting long caches
// across blocks (split-K), wider loads and int8 dot products are later
// work.
#include "attention_common.cuh"

namespace {

using attn::kFull;
using attn::kNegInf;
using attn::store;
using attn::Strides;
using attn::widen;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Rows of an f32 / bf16 cache, each element widened to f32 as it loads.
template <class C>
struct FpRows {
  const C* p;
  Strides s;
  struct Row {
    const C* r;
    __device__ float operator[](int d) const { return widen(r[d]); }
  };
  __device__ Row at(int b, int hk, int j) const {
    return {p + b * s.b + hk * s.h + (long long)j * s.s};
  }
};

// Rows of an int8 cache with one f32 scale per (token, kv head) (strides
// ss): each element widened and multiplied by its row's scale right after
// the load.
struct Q8Rows {
  const int8_t* p;
  const float* sc;
  Strides s, ss;
  struct Row {
    const int8_t* r;
    float scale;
    __device__ float operator[](int d) const {
      return static_cast<float>(r[d]) * scale;
    }
  };
  __device__ Row at(int b, int hk, int j) const {
    return {p + b * s.b + hk * s.h + (long long)j * s.s,
            sc[b * ss.b + hk * ss.h + (long long)j * ss.s]};
  }
};

template <class T, int D, class Rows>
__global__ void __launch_bounds__(kThreads)
decode_fwd(const T* __restrict__ q, Rows kc, Rows vc, T* __restrict__ out,
           Strides qs, const int* __restrict__ lens, int len_all, int smax,
           int h, int group, int window, float scale) {
  constexpr int kPer = (D + 31) / 32;
  __shared__ float red_m[kWarps], red_l[kWarps];
  __shared__ float red_acc[kWarps][D];
  const int hk = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = lens ? lens[b] : len_all;
  int hi = min(len, smax);
  int lo = window > 0 ? max(0, len - window) : 0;
  const bool none = lo >= hi;  // nothing valid: every score is masked
  if (none) lo = 0, hi = smax;

  for (int g = 0; g < group; ++g) {
    const int head = hk * group + g;
    const T* qp = q + b * qs.b + head * qs.h;
    float qr[kPer], acc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      qr[i] = d < D ? widen(qp[d]) * scale : 0.f;
      acc[i] = 0.f;
    }
    float m = -INFINITY, l = 0.f;
    for (int j = lo + warp; j < hi; j += kWarps) {
      const auto kr = kc.at(b, hk, j);
      const auto vr = vc.at(b, hk, j);
      float kx[kPer], vx[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int d = lane + 32 * i;
        kx[i] = d < D ? kr[d] : 0.f;
        vx[i] = d < D ? vr[d] : 0.f;
      }
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) a = fmaf(qr[i], kx[i], a);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_xor_sync(kFull, a, off);
      const float s = none ? kNegInf : a;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // 0 at the warp's first position
      const float p = expf(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(p, vx[i], acc[i] * alpha);
      m = m_new;
    }
    if (lane == 0) red_m[warp] = m, red_l[warp] = l;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < D) red_acc[warp][d] = acc[i];
    }
    __syncthreads();
    if (threadIdx.x < D) {  // merge the warps' partials in warp order
      const int d = threadIdx.x;
      float mm = red_m[0];
      for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, red_m[w]);
      float ll = 0.f, aa = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(red_m[w] - mm);  // 0 for a warp with no position
        ll = fmaf(red_l[w], f, ll);
        aa = fmaf(red_acc[w][d], f, aa);
      }
      store(out + ((long long)b * h + head) * D + d, aa / fmaxf(ll, 1e-20f));
    }
    __syncthreads();  // the partials are rewritten for the next head
  }
}

template <class T, int D, class Rows>
int launch(const void* q, Rows k, Rows v, void* out, Strides qs,
           const int* lens, int len_all, int b, int smax, int h, int kh,
           int window, float scale, cudaStream_t stream) {
  decode_fwd<T, D, Rows><<<dim3(kh, b), kThreads, 0, stream>>>(
      static_cast<const T*>(q), k, v, static_cast<T*>(out), qs, lens,
      len_all, smax, h, h / kh, window, scale);
  return (int)cudaGetLastError();
}

bool bad_shapes(int b, int smax, int h, int kh, int window) {
  return b < 1 || b > 65535 || kh < 1 || h < kh || h % kh != 0 ||
         smax < 1 || window < 0;
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (of q, out, and K6's cache).  q strides
// are those of its (B, H) dims (the sequence dim has one position); strides
// are in elements.  lens: (B,) int32 on the device, or null to give every
// slot len_all.  out is a contiguous (B, 1, H, D) tensor of q's dtype.
// Lengths must be >= 1 (the caller checks).  Returns a cudaError_t
// (cudaErrorInvalidValue for a head dim other than 32, 64, 80 or 128, or
// shapes the grid cannot hold).
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, void* out, long long qsb,
                                long long qsh, long long ksb, long long kss,
                                long long ksh, long long vsb, long long vss,
                                long long vsh, const int* lens, int len_all,
                                int b, int smax, int h, int kh, int d,
                                int window, float scale, cudaStream_t stream) {
  if (bad_shapes(b, smax, h, kh, window)) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, 0, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  return attn::dispatch<32, 64, 80, 128>(dtype, d, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dim)::value;
    return launch<T, D>(q, FpRows<T>{static_cast<const T*>(k), ks},
                        FpRows<T>{static_cast<const T*>(v), vs}, out, qs,
                        lens, len_all, b, smax, h, kh, window, scale, stream);
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
    int kh, int d, int window, float scale, cudaStream_t stream) {
  if (bad_shapes(b, smax, h, kh, window)) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, 0, qsh};
  const Q8Rows kr{static_cast<const int8_t*>(k),
                  static_cast<const float*>(k_scale), Strides{ksb, kss, ksh},
                  Strides{kssb, ksss, kssh}};
  const Q8Rows vr{static_cast<const int8_t*>(v),
                  static_cast<const float*>(v_scale), Strides{vsb, vss, vsh},
                  Strides{vssb, vsss, vssh}};
  return attn::dispatch<32, 64, 80, 128>(dtype, d, [&](auto t, auto dim) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dim)::value;
    return launch<T, D>(q, kr, vr, out, qs, lens, len_all, b, smax, h, kh,
                        window, scale, stream);
  });
}
