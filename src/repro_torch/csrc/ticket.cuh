// The ticket of the kernels that merge their blocks' partial results in
// the same launch (topk_tiled.cuh, decode_attention.cu).  Each block that
// wrote a partial takes a ticket from its group's zeroed counter after a
// block barrier; the block that draws the last one merges, then sets the
// counter back to 0 for the next launch on the stream.
#pragma once

namespace ticket {

// The counter's value before this block's increment.  acq_rel at gpu
// scope: the block's writes (ordered before it by the barrier) are
// released, and the last block acquires all the others'.
__device__ __forceinline__ int take(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

}  // namespace ticket
