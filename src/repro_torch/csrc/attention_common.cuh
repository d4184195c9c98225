// Support shared by the attention kernels (flash_attention.cu,
// decode_attention.cu): element strides of a (B, S, H, D) operand, f32 /
// bf16 loads and stores, 16-byte cp.async copies into shared memory, and
// the dispatch from the C interface's dtype code and head dim to a kernel
// instantiated for them.
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
