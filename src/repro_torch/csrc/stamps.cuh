// Per-block phase stamps, read by scripts/kernel_phases.py.  Built with
// -DKERNEL_STAMPS, thread 0 of each block writes the card's global timer
// (ns) at the points STAMP(k) marks into slot k (k < 7) of the block's 8;
// STAMP_SYNC(k) stamps after a block barrier (the slowest warp's end).
// Slot 7 holds the block's SM above bit 32 (STAMP_SM) and, below it, a
// count that lane 0 of a warp adds one to (STAMP_COUNT); each kernel says
// what it counts.  kernel_stamps_read copies the slots out and
// kernel_stamps_clear zeroes them.  In the normal build every macro is
// empty and the library has neither entry.
#pragma once

#include <cuda_runtime.h>

#ifdef KERNEL_STAMPS
constexpr int kStampBlocks = 1 << 14;
__device__ unsigned long long g_stamps[kStampBlocks * 8];

// this block's 8 slots, or nullptr past kStampBlocks
__device__ __forceinline__ unsigned long long* stamp_slots() {
  const unsigned b =
      (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  return b < kStampBlocks ? g_stamps + 8 * b : nullptr;
}

#define STAMP(k)                                                        \
  do {                                                                  \
    if (threadIdx.x == 0) {                                             \
      unsigned long long t_;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));            \
      if (unsigned long long* s_ = stamp_slots()) s_[k] = t_;           \
    }                                                                   \
  } while (0)
#define STAMP_SYNC(k) \
  do {                \
    __syncthreads();  \
    STAMP(k);         \
  } while (0)
#define STAMP_SM()                                                      \
  do {                                                                  \
    if (threadIdx.x == 0) {                                             \
      unsigned sm_;                                                     \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                  \
      if (unsigned long long* s_ = stamp_slots())                       \
        s_[7] = (unsigned long long)sm_ << 32;                          \
    }                                                                   \
  } while (0)
#define STAMP_COUNT()                                                   \
  do {                                                                  \
    if ((threadIdx.x & 31) == 0)                                        \
      if (unsigned long long* s_ = stamp_slots()) atomicAdd(s_ + 7, 1ull); \
  } while (0)

extern "C" int kernel_stamps_read(void* dst, long long n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n);
}
extern "C" int kernel_stamps_clear() {
  void* p;
  const cudaError_t err = cudaGetSymbolAddress(&p, g_stamps);
  return (int)(err ? err : cudaMemset(p, 0, sizeof(g_stamps)));
}
#else
#define STAMP(k)
#define STAMP_SYNC(k)
#define STAMP_SM()
#define STAMP_COUNT()
#endif
