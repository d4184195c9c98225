// Support shared by the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu, decode_attention.cu): element strides of a (B,
// S, H, D) operand, f32 / bf16 loads and stores, 16-byte cp.async copies
// into shared memory, the 3xTF32 products of the tensor cores (split, mma,
// mma3), and the dispatch from the C interface's dtype code and head dim
// to a kernel instantiated for them.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace attn {

constexpr float kNegInf = -1e30f;  // score of a masked key
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, s, h;  // element strides of the batch, sequence, head dims
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// two adjacent elements (p 8-byte aligned for f32, 4-byte for bf16)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// one 16-byte copy from global to shared memory (zero-filled unless valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// x = hi + lo, hi rounded to nearest at 11 significant bits (Veltkamp: t =
// x * 8193, hi = t - (t - x)); lo = x - hi is exact, and the tensor core
// reads its top 11 bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float t = __fmul_rn(x, 8193.f);
  const float h = __fsub_rn(t, __fsub_rn(t, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// c += a . b, one m16n8k8 TF32 product with f32 accumulators.  Fragments
// (g = lane / 4, t = lane % 4): a[0] A(g, t), a[1] A(g + 8, t), a[2] A(g,
// t + 4), a[3] A(g + 8, t + 4); b[0] B(t, g), b[1] B(t + 4, g); c[0] C(g,
// 2t), c[1] C(g, 2t + 1), c[2] C(g + 8, 2t), c[3] C(g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in 3xTF32 for a split A and a split B: lo.hi + hi.lo + hi.hi,
// small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(c, al, bh);
  mma(c, ah, bl);
  mma(c, ah, bh);
}

// c += a . b for a split A and a B exact in TF32 (a bf16 operand widened:
// its lo is 0, so that product is not issued): lo.hi + hi.hi, 3xTF32's
// order less the product of B's lo
__device__ __forceinline__ void mma2(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2]) {
  mma(c, al, bh);
  mma(c, ah, bh);
}

// c += a . b in 3xTF32 for a split A and a B of two f32 values: exact in
// TF32 (bf16 K / V: lo is 0, one product fewer) or split here.
template <bool kExact>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  if constexpr (kExact) {
    const uint32_t bh[2] = {__float_as_uint(b0), __float_as_uint(b1)};
    mma2(c, ah, al, bh);
  } else {
    uint32_t bh[2], bl[2];
    split(b0, bh[0], bl[0]);
    split(b1, bh[1], bl[1]);
    mma3(c, ah, al, bh, bl);
  }
}

template <class T>
struct Type {
  using type = T;
};
template <int D>
using Dim = std::integral_constant<int, D>;

template <class T, int... Ds, class F>
int by_dim(int d, F&& launch) {
  int err = (int)cudaErrorInvalidValue;
  (void)((d == Ds && ((err = launch(Type<T>{}, Dim<Ds>{})), true)) || ...);
  return err;
}

// Calls launch(Type<T>{}, Dim<D>{}) for dtype code 0 (float32) or 1
// (bfloat16) and a head dim D among the kernel's Ds (each instantiated);
// cudaErrorInvalidValue for anything else.  The launcher reads T and D
// back as typename decltype(t)::type and decltype(d)::value.
template <int... Ds, class F>
int dispatch(int dtype, int d, F&& launch) {
  if (dtype == 0) return by_dim<float, Ds...>(d, launch);
  if (dtype == 1) return by_dim<__nv_bfloat16, Ds...>(d, launch);
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn
