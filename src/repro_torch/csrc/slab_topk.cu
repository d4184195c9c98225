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
// What bounds it on the card: reading the member rows once per query that
// probes them (D x 4, 2 or 1 bytes a row, or m bytes of codes), plus the
// (Q, N) virt matrix.  At the main path's shapes that is a few MB, micro-
// seconds at 3.35 TB/s, so launch latency and the k selection rounds
// dominate.  Non-member rows are skipped (a warp-uniform branch for the
// dense modes), so the work follows the probed pairs and not Q x N.  The
// passes themselves are topk::launch<true> in topk_common.cuh.
#include "topk_common.cuh"

extern "C" int slab_topk_chunk_rows() { return topk::kChunk; }

// In every entry point: part_v / part_t / part_r are (Q, ceil(N / kChunk),
// k) scratch, and the return value is a cudaError_t.
extern "C" int slab_topk_fp32(const float* emb, const float* q,
                              const int* virt, int n, int d, int nq, int k,
                              float* part_v, int* part_t, int* part_r,
                              float* out_v, int* out_r, cudaStream_t stream) {
  return topk::launch<true>(topk::Dense<float, false>{emb, nullptr, d}, q, d,
                            virt, n, nq, k, part_v, part_t, part_r, out_v,
                            out_r, stream);
}

extern "C" int slab_topk_fp16(const __half* emb, const float* q,
                              const int* virt, int n, int d, int nq, int k,
                              float* part_v, int* part_t, int* part_r,
                              float* out_v, int* out_r, cudaStream_t stream) {
  return topk::launch<true>(topk::Dense<__half, false>{emb, nullptr, d}, q, d,
                            virt, n, nq, k, part_v, part_t, part_r, out_v,
                            out_r, stream);
}

extern "C" int slab_topk_int8(const int8_t* emb, const float* scales,
                              const float* q, const int* virt, int n, int d,
                              int nq, int k, float* part_v, int* part_t,
                              int* part_r, float* out_v, int* out_r,
                              cudaStream_t stream) {
  return topk::launch<true>(topk::Dense<int8_t, true>{emb, scales, d}, q, d,
                            virt, n, nq, k, part_v, part_t, part_r, out_v,
                            out_r, stream);
}

extern "C" int slab_topk_pq(const uint8_t* codes, const float* luts,
                            const int* virt, int n, int m, int nq, int k,
                            float* part_v, int* part_t, int* part_r,
                            float* out_v, int* out_r, cudaStream_t stream) {
  return topk::launch<true>(topk::PQ{codes, m}, luts, m * 256, virt, n, nq, k,
                            part_v, part_t, part_r, out_v, out_r, stream);
}
