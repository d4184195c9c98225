// slab_topk (fp32): ragged multi-query top-k over a packed cluster slab, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/slab_topk/kernel.py::slab_topk_pallas, mode
// "fp32" (the fp16/int8 and pq modes come with the storage-codec slice).
//
// Contract: emb (N, D) f32, queries (Q, D) f32, virt (Q, N) int32,
// 1 <= k <= N -> (vals (Q, k) f32, rows (Q, k) int32).  Row r competes for
// query q only when virt[q, r] < NOT_PROBED; the others score NEG_INF.
// Selection is (score desc, virt asc), so ties -- +0.0 against -0.0
// included -- resolve by the row's position in the query's virtual
// per-query concatenation.  Non-member rows all carry the key NOT_PROBED and
// come last, in row order (the lanes past a query's member count, which the
// caller masks).
//
// What bounds it on the card: reading the member rows of the slab once per
// query that probes them, plus the (Q, N) virt matrix.  At the main path's
// shape (N ~ 4-6 k rows, D = 768, Q = 16, k = 10) that is a few MB and
// ~0.1 GFLOP, microseconds at 3.35 TB/s, so launch latency and the k
// selection rounds dominate.  The design reads virt first and skips the
// dot product of every non-member row (a warp-uniform branch), so the work
// follows the probed pairs and not Q x N; scores stay a fixed-order sum
// per (query, row) so a batch equals its queries run one at a time.  The
// passes themselves are topk::launch<true> in topk_common.cuh.
#include "topk_common.cuh"

extern "C" int slab_topk_chunk_rows() { return topk::kChunk; }

// part_v / part_t / part_r: (Q, ceil(N / kChunk), k) scratch.  Returns a
// cudaError_t.
extern "C" int slab_topk_fp32(const float* emb, const float* q,
                              const int* virt, int n, int d, int nq, int k,
                              float* part_v, int* part_t, int* part_r,
                              float* out_v, int* out_r, cudaStream_t stream) {
  return topk::launch<true>(emb, q, virt, n, d, nq, k, part_v, part_t, part_r,
                            out_v, out_r, stream);
}
