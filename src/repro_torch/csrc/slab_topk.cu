// slab_topk: ragged multi-query top-k over a packed cluster slab, for Hopper
// (sm_90a), in four modes: fp32, fp16, int8 (scaled) and pq.
//
// Replaces: src/repro/kernels/slab_topk/kernel.py::slab_topk_pallas, modes
// "fp32" (K2), fp16 and int8 "scaled" (K3: the TPU kernel widens the f16
// block in VMEM, kernel.py:116, and scales the int8 score tile, :121-123)
// and "pq" (K4: m one-hot matmuls against the LUTs, kernel.py:102-114).
//
// Contract: virt (Q, N) int32, 1 <= k <= N -> (vals (Q, k) f32, rows (Q, k)
// int32), and per mode
//   fp32  emb (N, D) f32, queries (Q, D) f32;
//   fp16  emb (N, D) __half, queries (Q, D) f32;
//   int8  emb (N, D) int8, scales (N,) f32 (the (N, 1) column), queries f32;
//   pq    codes (N, m) uint8, luts (Q, m, 256) f32 (the tables replace the
//         queries).
// Any D >= 1 and any m >= 1.  Row r competes for query q only when virt[q,
// r] < NOT_PROBED; the others score NEG_INF.  Selection is (score desc,
// virt asc), so ties -- +0.0 against -0.0 included -- resolve by the row's
// position in the query's virtual per-query concatenation.  Non-member rows
// all carry the key NOT_PROBED and come last, in row order (the lanes past
// a query's member count, which the caller masks).
//
// Every mode is one launch of topk::tiled::score_merge (topk_tiled.cuh),
// with its merge inside: a block per (row tile, 16-query tile) reads the
// tile's member rows once -- in their own type: no f32 copy of an fp16 or
// int8 slab exists anywhere -- through a cp.async pipeline that stages D
// (or pq's tables) a slice at a time, so nothing bounds D or m; it scores
// them in registers, selects across a warp, and the last block of each
// query tile merges.  fp16 rows are widened exactly before the fp32
// arithmetic, so fp16 gives the fp32 mode's bits on the widened slab;
// int8 the same, then times the row's scale (one rounding), so int8 with
// unit scales gives fp32's bits on its widened values.  pq adds the table
// entries in ascending subspace, the plain version's order: bitwise equal
// to it on any input.
//
// What bounds it on the card: reading the member rows once (D x 4, 2 or 1
// bytes a row, or m bytes of codes), the queries or tables, and the (Q, N)
// virt matrix.  At the main path's fp32 shape (N ~15,600, D 768, Q 16)
// nearly every row is a member of some query: ~48 MB, 0.0146 ms at 3.35
// TB/s, against 5.7 us for all 16 x N dot products at the 67 TFLOP/s fp32
// peak.  At the codec paths' shapes (~9,500 rows) the bytes are 15 MB
// (fp16), 8 MB (int8) or under 1 MB (pq), and a query probes a few of a
// tile's rows, so the launch's latency chain -- virt, the rows, selection,
// the merge -- weighs as much as the bytes; topk_tiled.cuh says what each
// mode's scoring does about it.
#include "topk_tiled.cuh"

extern "C" size_t slab_topk_scratch_bytes(int n, int nq, int k) {
  return topk::tiled::scratch_bytes(n, nq, k);
}

// Every entry point: emb (the slab, or pq's codes), q (the queries, or
// pq's tables), scales (int8's; null in the other modes), virt, n, d (pq:
// m), nq, k; scratch: slab_topk_scratch_bytes(n, nq, k) bytes; tickets:
// `ntickets` >= ceil(nq / 16) + nq zeroed ints that only this stream uses
// (zero again when the kernel ends); out_v / out_r (Q, k).  Returns a
// cudaError_t.
#define SLAB_TOPK_ENTRY(name, mode)                                         \
  extern "C" int name(const void* emb, const float* q, const float* scales, \
                      const int* virt, int n, int d, int nq, int k,         \
                      void* scratch, int* tickets, long long ntickets,      \
                      float* out_v, int* out_r, cudaStream_t stream) {      \
    return topk::tiled::launch<topk::tiled::mode>(                          \
        emb, q, scales, virt, n, d, nq, k, scratch, tickets, ntickets,      \
        out_v, out_r, stream);                                              \
  }

SLAB_TOPK_ENTRY(slab_topk_fp32, kF32)
SLAB_TOPK_ENTRY(slab_topk_fp16, kF16)
SLAB_TOPK_ENTRY(slab_topk_int8, kI8)
SLAB_TOPK_ENTRY(slab_topk_pq, kPq)
