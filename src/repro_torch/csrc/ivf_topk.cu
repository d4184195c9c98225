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
// D = 768, Q = 16: ~0.4 MB read, ~3 MFLOP; 0.00013 ms at 3.35 TB/s), so
// no rate of the card sets its time: the latency of one launch does, and
// the chains inside it -- a row tile's loads, a row's D-long FMA chains,
// the selection and the merge.  The design is one launch with no host sync
// (topk::tiled::launch<kIvf> in topk_tiled.cuh, where every row competes
// and the tie key is the row): 16-row tiles put the 125 rows on 8 blocks,
// each reading its rows and the queries once, all of D in flight at once;
// each score is four interleaved FMA chains of D / 4; a warp sorts each
// tile's keys of two queries, and the last block to finish sorts the
// tiles' candidates, in the same launch.  The TPU's running top-k across
// sequential grid steps has no counterpart (blocks run in parallel, in no
// order).
#include "topk_tiled.cuh"

extern "C" size_t ivf_topk_scratch_bytes(int n, int nq, int k) {
  return topk::tiled::scratch_bytes(n, nq, k);
}

// scratch: ivf_topk_scratch_bytes(n, nq, k) bytes; tickets: `ntickets` >=
// ceil(nq / 16) + nq zeroed ints that only this stream uses (zero again when
// the kernel ends).  Returns a cudaError_t.
extern "C" int ivf_topk(const float* emb, const float* q, int n, int d, int nq,
                        int k, void* scratch, int* tickets, long long ntickets,
                        float* out_v, int* out_i, cudaStream_t stream) {
  return topk::tiled::launch<topk::tiled::kIvf>(
      emb, q, nullptr, nullptr, n, d, nq, k, scratch, tickets, ntickets,
      out_v, out_i, stream);
}
