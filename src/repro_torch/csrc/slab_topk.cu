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
// Row r competes for query q only when virt[q, r] < NOT_PROBED; the others
// score NEG_INF.  Selection is (score desc, virt asc), so ties -- +0.0
// against -0.0 included -- resolve by the row's position in the query's
// virtual per-query concatenation.  Non-member rows all carry the key
// NOT_PROBED and come last, in row order (the lanes past a query's member
// count, which the caller masks).
//
// The slab is read in its compact type: fp16 and int8 rows are widened to
// f32 in registers, one element at a time, so no f32 copy of a slab exists
// anywhere; int8 multiplies the finished row score by its scale, as the TPU
// kernel scales the score tile after an f32 dot.  PQ needs no one-hot
// matmuls (they stand in for a gather VMEM lacks): the block holds its
// query's m x 256 tables in shared memory and each row's score is m
// gathers and adds.
//
// What bounds it on the card: reading the member rows once (D x 4, 2 or 1
// bytes a row, or m bytes of codes), the queries or tables, and the (Q, N)
// virt matrix.
//   fp32 (K2): at the main path's shape (N ~15,600, D 768, Q 16) nearly
//   every row of the slab is a member of some query: ~48 MB, 0.0146 ms at
//   3.35 TB/s, against 5.7 us for all 16 x N dot products at the 67 TFLOP/s
//   fp32 peak.  topk::tiled::launch<true> (topk_tiled.cuh) reads each row
//   once per tile of 16 queries, through a cp.async pipeline that the
//   staging warps run ahead of the computing ones, scores it with fp32 FMAs
//   in registers, skips the FMAs of warps whose pairs do not compete,
//   selects by sorting across a warp and merges in the same launch: one
//   launch, bound by the bytes.
//   fp16, int8, pq (K3, K4): a few MB at the codec paths' shapes, so launch
//   latency and the k selection rounds bound them; topk::launch
//   (topk_common.cuh): a block per (256-row chunk, query), a warp per row
//   (a thread per row for pq), non-members skipped by a warp-uniform
//   branch, then a merge launch.
#include "topk_common.cuh"
#include "topk_tiled.cuh"

extern "C" int slab_topk_chunk_rows() { return topk::kChunk; }

extern "C" size_t slab_topk_fp32_scratch_bytes(int n, int nq, int k) {
  return topk::tiled::scratch_bytes(n, nq, k);
}

// scratch: slab_topk_fp32_scratch_bytes(n, nq, k) bytes; tickets:
// `ntickets` >= ceil(nq / 16) + nq zeroed ints that only this stream uses
// (zero again when the kernel ends).  Returns a cudaError_t.
extern "C" int slab_topk_fp32(const float* emb, const float* q,
                              const int* virt, int n, int d, int nq, int k,
                              void* scratch, int* tickets, long long ntickets,
                              float* out_v, int* out_r, cudaStream_t stream) {
  return topk::tiled::launch<true>(emb, q, virt, n, d, nq, k, scratch, tickets,
                                   ntickets, out_v, out_r, stream);
}

// In the other entry points: part_v / part_t / part_r are (Q, ceil(N /
// kChunk), k) scratch, and the return value is a cudaError_t.
extern "C" int slab_topk_fp16(const __half* emb, const float* q,
                              const int* virt, int n, int d, int nq, int k,
                              float* part_v, int* part_t, int* part_r,
                              float* out_v, int* out_r, cudaStream_t stream) {
  return topk::launch(topk::Dense<__half, false>{emb, nullptr, d}, q, d, virt,
                      n, nq, k, part_v, part_t, part_r, out_v, out_r, stream);
}

extern "C" int slab_topk_int8(const int8_t* emb, const float* scales,
                              const float* q, const int* virt, int n, int d,
                              int nq, int k, float* part_v, int* part_t,
                              int* part_r, float* out_v, int* out_r,
                              cudaStream_t stream) {
  return topk::launch(topk::Dense<int8_t, true>{emb, scales, d}, q, d, virt,
                      n, nq, k, part_v, part_t, part_r, out_v, out_r, stream);
}

extern "C" int slab_topk_pq(const uint8_t* codes, const float* luts,
                            const int* virt, int n, int m, int nq, int k,
                            float* part_v, int* part_t, int* part_r,
                            float* out_v, int* out_r, cudaStream_t stream) {
  return topk::launch(topk::PQ{codes, m}, luts, m * 256, virt, n, nq, k,
                      part_v, part_t, part_r, out_v, out_r, stream);
}
