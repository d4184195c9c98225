// ivf_topk: Q x N inner products with a top-k per query, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ivf_topk/kernel.py::topk_ip_pallas (the TPU
// kernel that streams candidate blocks through VMEM and keeps a running
// (BLOCK_Q, k) best in scratch across the sequential N grid axis).
//
// Contract: embs (N, D) f32, queries (Q, D) f32, 1 <= k <= N ->
// (vals (Q, k) f32, idx (Q, k) int32), best first, ties to the lower index
// (the lax.top_k order of the reference).
//
// What bounds it on the card: the centroid probe is tiny (N = nlist ~ 125,
// D = 768, Q = 16: ~0.4 MB read, ~3 MFLOP), far below a microsecond at
// 3.35 TB/s, so launch latency and the k selection rounds bound it, not
// bytes or FLOPs.  The design keeps it to two launches with no host sync
// and no scratch beyond the (Q, chunks, k) partial lists.  The TPU's running
// top-k across sequential grid steps has no counterpart here (blocks run in
// parallel, in no order), so each block selects its chunk's top k and a
// second pass merges them under the same total order: topk::launch<false>
// in topk_common.cuh with the fp32 Dense scorer, where every row competes
// and the tie key is the row.
#include "topk_common.cuh"

extern "C" int ivf_topk_chunk_rows() { return topk::kChunk; }

// part_v / part_t / part_i: (Q, ceil(N / kChunk), k) scratch.  Returns a
// cudaError_t.
extern "C" int ivf_topk(const float* emb, const float* q, int n, int d, int nq,
                        int k, float* part_v, int* part_t, int* part_i,
                        float* out_v, int* out_i, cudaStream_t stream) {
  return topk::launch<false>(topk::Dense<float, false>{emb, nullptr, d}, q, d,
                             nullptr, n, nq, k, part_v, part_t, part_i, out_v,
                             out_i, stream);
}
