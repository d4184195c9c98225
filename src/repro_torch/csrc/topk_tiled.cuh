// Dense fp32 top-k in one launch: the scoring, selection and merge of the
// port's ivf_topk (K1, kMasked = false) and fp32 slab_topk (K2, kMasked =
// true).  The fp16, int8 and pq slabs keep the two-pass topk::launch of
// topk_common.cuh, whose Key and total order this reuses.
//
// Grid: one block of 256 threads per (row tile, query tile).  A query tile
// holds up to 16 queries (the main path's 16 are one tile).  A row tile
// holds kRows rows, picked from N alone: 16 rows while N <= 2,048 (the
// centroid probe's 125 rows spread over 8 blocks), 64 above (the fp32
// slab's ~15,600 rows give ~245 blocks, two on each SM).
//
//   1. Members (slab_topk).  The block reads its (query tile, row tile)
//      slice of virt.  Row r competes for query q only when virt[q, r] <
//      kNotProbed, with tie key virt[q, r]; a row that no query of the tile
//      probes is never read, and a tile with no member reads no rows.  In
//      ivf_topk every row competes and the tie key is the row.  Each
//      query's count of candidates here, min(k, members), gets its offset
//      in the query's candidate array from an atomicAdd on the query's fill
//      counter, whose answer is needed only after the scoring.
//   2. Scoring.  The tile's member rows and its queries are staged through
//      shared memory by 16-byte cp.async, 64 floats of D a slice (so any D
//      works: nothing holds a whole query), each row once per query tile.
//      The slices run through kStages stages with mbarriers and no block
//      barrier: every thread stages its share of a slice kStages - 1 ahead
//      and arrives on the slice's `full` barrier when its copies land
//      (cp.async.mbarrier.arrive); a computing warp waits on `full`,
//      computes, and arrives on `empty`, which the slice kStages later
//      waits for.  16-row tiles: all 8 warps compute, a query x a row a
//      thread, 11 slices in flight (all of D = 768).  64-row tiles: warps
//      0-3 compute, 4 queries x 2 rows a thread, while warps 4-7 only stage
//      and run ahead.  A thread's rows are conflict-free float4 reads and
//      its queries warp-wide broadcasts; a warp none of whose (query, row)
//      pairs competes skips the FMAs.  An operand not on a 16-byte
//      boundary, or D % 4 != 0, is staged into the same tiles by plain
//      loads.
//      Every (query, row) score is one fixed-order fp32 computation: four
//      FMA chains over the elements d = 0, 1, 2, 3 (mod 4), each in
//      ascending d, then (c0 + c1) + (c2 + c3).  It depends on D alone --
//      not on Q, N, the tile height or where the row falls -- so a batch
//      gives bitwise the result of its queries run one at a time.
//   3. Selection.  A warp takes two of the queries with members here: its
//      lanes hold their keys (packed in 64 bits: score over tie key), and
//      rounds of __reduce_max_sync on the score take each query's best
//      min(k, members) as a set, written to its candidate array; the best
//      score goes to the query's `heads` entry for this tile.  A tie at
//      the last place, which only the tie key can break, falls back to a
//      bitonic sort across the warp.
//   4. Merge, in the same launch.  Each block takes a ticket from its query
//      tile's counter (one acq_rel atomicAdd after the block's barrier).
//      The last block merges the tile's queries, a warp per two queries:
//      counts, heads and candidates in one round trip; with more than 64
//      candidates, a threshold -- the k-th best of the lanes' best heads,
//      so k tiles hold a candidate at least that good -- drops the
//      candidates under it; when at most 64 are left and k <= 64, they are
//      sorted across the warp (bitonic) and the first k are the answer.
//      Otherwise (and for slab_topk when fewer than k members score >=
//      kNegInf) k rounds of warp reductions over every candidate, where the
//      rows that do not compete -- key (kNegInf, kNotProbed, row), so after
//      every member scoring >= kNegInf, in row order -- are found in virt
//      when one can win a round.  The block then zeroes the counters it
//      used, so the next launch on the stream finds them 0; the caller
//      keeps one zeroed counter array per (card, stream).
// Selection is under one TOTAL order (score desc, tie key asc, row asc;
// topk::before), so the best k of the union of per-tile candidates is the
// global best k whichever block merges, whatever order the atomics hand
// out, and a query's result does not depend on the other queries or on the
// tile heights.
#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "ticket.cuh"
#include "topk_common.cuh"

namespace topk {
namespace tiled {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 16;           // queries per query tile
constexpr int kDK = 64;           // floats of D a stage
constexpr int kPitch = kDK + 4;   // staged row, floats (conflict-free float4)
constexpr int kSmallN = 2048;     // N up to this: 16-row tiles; above: 64
constexpr int kMaxQueryTiles = 65535;  // the grid's y extent

// A key packed for compare-exchanges: k holds the score's image over the
// tie key's image, inverted, so that a larger k is ahead in the total order
// (score desc, tie key asc); the row breaks ties of k.
struct PKey {
  unsigned long long k;
  int r;
};

// a candidate in scratch or shared memory (16 bytes: one load)
struct alignas(16) Cand {
  unsigned long long k;
  int r, pad;
};

template <int kRows>
struct Geo {
  // 16-row tiles: every (query, row) pair of a centroid probe competes, so
  // all 8 warps compute (a query x a row a thread).  64-row tiles: warps
  // 0-3 compute (4 queries x 2 rows a thread) and warps 4-7 only stage, so
  // they run ahead of the FMAs.  Every warp stages a share of each slice.
  static constexpr bool kSmall = kRows == 16;
  static constexpr int kStages = kSmall ? 12 : 4;
  static constexpr int kComputeWarps = kSmall ? kWarps : 4;
  static constexpr int kRW = kSmall ? 16 : 32;  // rows across a warp's lanes
  static constexpr int kRPT = kRows / kRW;      // rows a thread
  static constexpr int kSub = 32 / kRW;         // query sets within a warp
  static constexpr int kQPT = kQT / (kComputeWarps * kSub);  // queries
  static constexpr int kStageFloats = (kRows + kQT) * kPitch;
  // stages, then the (kQT, kRows) scores and tie keys; the merge reuses it
  static constexpr int kBytes = (kStages * kStageFloats + 2 * kQT * kRows) * 4;

  static_assert(kQPT * kComputeWarps * kSub == kQT,
                "the compute warps must cover the (query, row) tile");
  static_assert(kQT <= 2 * kWarps, "a warp merges at most two queries");
  static_assert(kWarps * 2 * 64 * (int)sizeof(Cand) <= kBytes,
                "room for the merge's sorted candidates");
};
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}
// arrives when this thread's cp.async copies issued so far have landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}
// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// topk::before without branches (a warp's lanes compare different keys):
// score desc, then tie key asc, then row asc; +0.0 and -0.0 tie
__device__ __forceinline__ bool ahead(const Key& a, const Key& b) {
  const bool gt = a.s > b.s, lt = a.s < b.s;
  return gt | (!(gt | lt) & ((a.t < b.t) | ((a.t == b.t) & (a.r < b.r))));
}
__device__ __forceinline__ Key pick(bool first, const Key& a, const Key& b) {
  return Key{first ? a.s : b.s, first ? a.t : b.t, first ? a.r : b.r};
}
// unsigned images of the key's fields that order as the total order does:
// a larger score image is a better score (+0.0 and -0.0 alike), a smaller
// tie key or row image is better
__device__ __forceinline__ unsigned score_image(float s) {
  const unsigned u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned int_image(int t) {
  return (unsigned)t ^ 0x80000000u;
}

__device__ __forceinline__ PKey pack(float s, int t, int r) {
  return PKey{((unsigned long long)score_image(s) << 32) | ~int_image(t), r};
}
__device__ __forceinline__ float score_of(const PKey& p) {
  const unsigned img = (unsigned)(p.k >> 32);
  return __uint_as_float((img & 0x80000000u) ? (img & 0x7fffffffu) : ~img);
}
__device__ __forceinline__ Key unpack(const PKey& p) {
  return Key{score_of(p), (int)(~(unsigned)p.k ^ 0x80000000u), p.r};
}
__device__ __forceinline__ PKey worst_packed() { return PKey{0ull, INT_MAX}; }
__device__ __forceinline__ bool ahead(const PKey& a, const PKey& b) {
  return (a.k > b.k) | ((a.k == b.k) & (a.r < b.r));
}
__device__ __forceinline__ PKey pick(bool first, const PKey& a,
                                     const PKey& b) {
  return PKey{first ? a.k : b.k, first ? a.r : b.r};
}
__device__ __forceinline__ PKey shfl_xor(const PKey& p, int mask) {
  return PKey{__shfl_xor_sync(kFull, p.k, mask),
              __shfl_xor_sync(kFull, p.r, mask)};
}

// Sorts the keys k[u][e] of lane l (index 32 e + l, e < kE) across the
// warp, best first, for two independent sets u at once: a bitonic network
// of compare-exchanges, by shuffles across lanes and in registers across e
// (kE = 1: 32 keys, 15 stages; kE = 2: 64 keys, 21 stages).
template <int kE>
__device__ __forceinline__ void sort_warp(PKey (&k)[2][2], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * kE; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (stride == 32) {   // partners in the same lane
          const bool swap = ahead(k[u][1], k[u][0]);
          const PKey lo = pick(swap, k[u][1], k[u][0]);
          k[u][1] = pick(swap, k[u][0], k[u][1]);
          k[u][0] = lo;
        } else {
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            const int i = 32 * e + lane;
            const bool best_side = ((i & stride) == 0) == ((i & size) == 0);
            const PKey o = shfl_xor(k[u][e], stride);
            k[u][e] = pick(ahead(o, k[u][e]) == best_side, o, k[u][e]);
          }
        }
      }
    }
  }
}

// a candidate written by another block: read through L2
__device__ __forceinline__ PKey load_cand(const Cand* p) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
  return PKey{((unsigned long long)(unsigned)v.y << 32) | (unsigned)v.x,
              v.z};
}

// the lane whose key is first in the total order, the same on every lane
__device__ __forceinline__ int arg_best(const Key& h, int lane) {
  const unsigned s = score_image(h.s);
  const unsigned top = __reduce_max_sync(kFull, s);
  unsigned tied = __ballot_sync(kFull, s == top);
  if (__popc(tied) > 1) {   // equal scores: the lower tie key, then row
    const bool in = (tied >> lane) & 1u;
    const unsigned tmin =
        __reduce_min_sync(kFull, in ? int_image(h.t) : 0xffffffffu);
    tied = __ballot_sync(kFull, in && int_image(h.t) == tmin);
    if (__popc(tied) > 1) {
      const bool in2 = (tied >> lane) & 1u;
      const unsigned rmin =
          __reduce_min_sync(kFull, in2 ? int_image(h.r) : 0xffffffffu);
      tied = __ballot_sync(kFull, in2 && int_image(h.r) == rmin);
    }
  }
  return __ffs(tied) - 1;
}

// the key of the first row >= from that does not compete for this query
// (vrow: its virt row), or worst() when there is none
__device__ Key next_outsider(const int* __restrict__ vrow, int n, int from,
                             int lane) {
  for (int r0 = from; r0 < n; r0 += 32) {
    const int r = r0 + lane;
    const unsigned b =
        __ballot_sync(kFull, r < n && __ldg(vrow + r) >= kNotProbed);
    if (b) return Key{kNegInf, kNotProbed, r0 + __ffs(b) - 1};
  }
  return worst();
}

// The general merge of one query by one warp: the best k of its `total`
// candidates in scratch (gbuf) and, when kMasked, of the rows outside it
// (vrow: its virt row): k rounds of arg_best over the lanes' heads.
template <bool kMasked>
__device__ void merge_rounds(const Cand* gbuf, int total, const int* vrow,
                             int n, int k, int lane, float* out_v,
                             int* out_r) {
  // this lane's best candidate strictly after prev (after nothing: first)
  auto head_after = [&](const Key& prev, bool first) {
    Key h = worst();
#pragma unroll 4
    for (int c = lane; c < total; c += 32) {
      const Key x = unpack(load_cand(gbuf + c));
      h = pick((first | ahead(prev, x)) & ahead(x, h), x, h);
    }
    return h;
  };
  Key head = head_after(worst(), true), outsider = worst();
  int from = 0;
  bool found = false;
  for (int i = 0; i < k; ++i) {
    const int w = arg_best(head, lane);
    Key best{__shfl_sync(kFull, head.s, w), __shfl_sync(kFull, head.t, w),
             __shfl_sync(kFull, head.r, w)};
    bool member = true;
    if constexpr (kMasked) {
      if (!(best.s >= kNegInf)) {   // a row outside may come first
        if (!found) {
          outsider = next_outsider(vrow, n, from, lane);
          found = true;
        }
        if (ahead(outsider, best)) {
          best = outsider;
          member = false;
          from = outsider.r + 1;
          found = false;
        }
      }
    }
    if (lane == 0) {
      out_v[i] = best.s;
      out_r[i] = best.r;
    }
    if (member && lane == w) head = head_after(best, false);
  }
}

// emb (N, d), q (Q, d), virt (Q, N) when kMasked.  cand: (Q, cap)
// candidates, cap = ntiles * min(k, kRows); heads: (Q, ntiles) score images
// of each tile's best candidate (0: none); tickets: the query tiles'
// counters, then the queries' fill counters, all zero, zero again when the
// launch ends.
template <bool kMasked, int kRows>
__global__ void __launch_bounds__(kThreads, 2)
score_merge(const float* __restrict__ emb, const float* __restrict__ q,
            const int* __restrict__ virt, int n, int d, int nq, int k, int vec,
            Cand* __restrict__ cand, unsigned* __restrict__ heads,
            int* tickets, float* __restrict__ out_v, int* __restrict__ out_r) {
  using G = Geo<kRows>;
  constexpr int kAhead = G::kStages - 1;   // slices in flight
  extern __shared__ __align__(16) float smem[];
  float* sc = smem + G::kStages * G::kStageFloats;        // (kQT, kRows)
  int* vt = reinterpret_cast<int*>(sc + kQT * kRows);     // (kQT, kRows)
  __shared__ __align__(8) uint64_t full[G::kStages], empty[G::kStages];
  __shared__ bool row_on[kRows];
  __shared__ int kq_of[kQT], off_of[kQT], with_kq[kQT], n_with, last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int row0 = tile * kRows, rows = min(kRows, n - row0);
  const int nqtiles = (nq + kQT - 1) / kQT;
  const int q0 = blockIdx.y * kQT, nqt = min(kQT, nq - q0);
  const size_t cap = (size_t)ntiles * min(k, kRows);
  int* fill = tickets + nqtiles;                          // (Q,)
  if (tid == 0) {
    for (int i = 0; i < G::kStages; ++i) {
      mbar_init(&full[i], kThreads);            // every thread's copies
      mbar_init(&empty[i], G::kComputeWarps);   // every computing warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // ---- 1. which (query, row) pairs compete ------------------------------
  if constexpr (kMasked) {
    for (int i = tid; i < kQT * kRows; i += kThreads) {
      const int qi = i / kRows, c = i - qi * kRows;
      vt[i] = qi < nqt && c < rows
                  ? min(__ldg(virt + (size_t)(q0 + qi) * n + row0 + c),
                        kNotProbed)
                  : kNotProbed;
    }
    __syncthreads();
  }
  auto member = [&](int qi, int c) {
    if constexpr (kMasked)
      return vt[qi * kRows + c] < kNotProbed;
    else
      return qi < nqt && c < rows;
  };
  if (tid < kRows) {
    bool on = false;
    for (int qi = 0; qi < kQT; ++qi) on |= member(qi, tid);
    row_on[tid] = on;
  }

  // each query's number of candidates here, and their place in its array
  // (the atomic's answer is needed only after the scoring)
  // (and the list of the queries that have any, for phase 3)
  if (warp == 0) {
    int kq = 0;
    if (lane < nqt) {
      int m = 0;
      for (int c = 0; c < kRows; ++c) m += member(lane, c);
      kq = min(k, m);
      kq_of[lane] = kq;
      off_of[lane] = kq ? atomicAdd(fill + q0 + lane, kq) : 0;
      if (!kq) heads[(size_t)(q0 + lane) * ntiles + tile] = 0;
    }
    const unsigned has = __ballot_sync(kFull, kq > 0);
    if (kq > 0) with_kq[__popc(has & ((1u << lane) - 1))] = lane;
    if (lane == 0) n_with = __popc(has);
  }

  // ---- 2. scoring: this thread's kQPT queries x kRPT rows ---------------
  const bool computes = warp < G::kComputeWarps;
  const int lr = lane % G::kRW;                       // rows lr + kRW i
  const int qb = (warp * G::kSub + lane / G::kRW) * G::kQPT;
  bool mine = false;
#pragma unroll
  for (int j = 0; j < G::kQPT; ++j)
#pragma unroll
    for (int i = 0; i < G::kRPT; ++i)
      mine |= computes && member(qb + j, lr + G::kRW * i);
  const bool warp_on = __any_sync(kFull, mine);
  const bool any_on = __syncthreads_or(tid < kRows && row_on[tid]);

  // Thread tid's share of slice `slice` (the member rows and the queries;
  // columns past d are zeros, so they add exact zeros), then its arrival
  // on the slice's `full` barrier.
  auto stage = [&](int slice) {
    const int st = slice % G::kStages;
    float* dst = smem + st * G::kStageFloats;
    const int d0 = slice * kDK;
    if (slice >= G::kStages)   // its stage's previous slice is consumed
      mbar_wait(&empty[st], (slice / G::kStages - 1) & 1);
    if (vec) {
      constexpr int kPer = kDK / 4;   // 16-byte copies a staged row
      for (int c = tid; c < (kRows + kQT) * kPer; c += kThreads) {
        const int rr = c / kPer, e = (c - rr * kPer) * 4;
        if (rr < kRows ? !row_on[rr] : rr - kRows >= nqt) continue;
        const float* src = rr < kRows ? emb + (size_t)(row0 + rr) * d
                                      : q + (size_t)(q0 + rr - kRows) * d;
        const bool ok = d0 + e < d;
        cp_async16(dst + rr * kPitch + e, ok ? src + d0 + e : src, ok);
      }
      mbar_arrive_copies(&full[st]);
    } else {
      for (int c = tid; c < (kRows + kQT) * kDK; c += kThreads) {
        const int rr = c / kDK, e = c - rr * kDK;
        if (rr < kRows ? !row_on[rr] : rr - kRows >= nqt) continue;
        const float* src = rr < kRows ? emb + (size_t)(row0 + rr) * d
                                      : q + (size_t)(q0 + rr - kRows) * d;
        dst[rr * kPitch + e] = d0 + e < d ? src[d0 + e] : 0.f;
      }
      mbar_arrive(&full[st]);
    }
  };
  // A pipeline without block barriers: every thread stages its share of
  // each slice, kAhead slices ahead; a computing warp waits for a slice's
  // `full` barrier, computes, and arrives on its `empty` barrier, which the
  // stagers of the slice kStages later wait for.  Warps that do not compute
  // stage ahead without waiting for the FMAs.
  if (any_on) {
    const int slices = (d + kDK - 1) / kDK;
    for (int s = 0; s < kAhead && s < slices; ++s) stage(s);
    if (!computes) {
      for (int s = kAhead; s < slices; ++s) stage(s);
    } else {
      float acc[G::kQPT][G::kRPT][4] = {};
      for (int s = 0; s < slices; ++s) {
        mbar_wait(&full[s % G::kStages], (s / G::kStages) & 1);
        if (warp_on) {
          const float* st = smem + (s % G::kStages) * G::kStageFloats;
          const float* rp = st + lr * kPitch;
          const float* qp = st + (kRows + qb) * kPitch;
#pragma unroll
          for (int e = 0; e < kDK; e += 4) {
            float4 x[G::kRPT];
#pragma unroll
            for (int i = 0; i < G::kRPT; ++i)
              x[i] = *reinterpret_cast<const float4*>(
                  rp + G::kRW * i * kPitch + e);
#pragma unroll
            for (int j = 0; j < G::kQPT; ++j) {
              const float4 y =
                  *reinterpret_cast<const float4*>(qp + j * kPitch + e);
#pragma unroll
              for (int i = 0; i < G::kRPT; ++i) {
                acc[j][i][0] = fmaf(x[i].x, y.x, acc[j][i][0]);
                acc[j][i][1] = fmaf(x[i].y, y.y, acc[j][i][1]);
                acc[j][i][2] = fmaf(x[i].z, y.z, acc[j][i][2]);
                acc[j][i][3] = fmaf(x[i].w, y.w, acc[j][i][3]);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s % G::kStages]);
        if (s + kAhead < slices) stage(s + kAhead);
      }
      if (warp_on) {
#pragma unroll
        for (int j = 0; j < G::kQPT; ++j)
#pragma unroll
          for (int i = 0; i < G::kRPT; ++i)
            sc[(qb + j) * kRows + lr + G::kRW * i] =
                (acc[j][i][0] + acc[j][i][1]) +
                (acc[j][i][2] + acc[j][i][3]);
      }
    }
  }

  // ---- 3. the tile's best min(k, members) rows of each query ------------
  // A warp takes two of the queries that have members here (non-members
  // hold the worst key) and writes each one's best kq.
  __syncthreads();
  {
    constexpr int kE = (kRows + 31) / 32;   // keys a lane
    const int qa = warp < n_with ? with_kq[warp] : kQT;
    const int qz = warp + kWarps < n_with ? with_kq[warp + kWarps] : kQT;
    const int kqa = qa < nqt ? kq_of[qa] : 0, kqz = qz < nqt ? kq_of[qz] : 0;
    if (kqa | kqz) {
      PKey x[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = u ? qz : qa, c = 32 * e + lane;
          x[u][e] = e < kE && c < kRows && qi < nqt && member(qi, c)
                        ? pack(sc[qi * kRows + c],
                               kMasked ? vt[qi * kRows + c] : row0 + c,
                               row0 + c)
                        : worst_packed();
        }
      // Rounds of __reduce_max_sync over the lanes' next score images take
      // the kq best as a set (the merge sorts); a tie at the kq-th place,
      // which only the tie key can break, falls back to sorting.
#pragma unroll
      for (int u = 0; u < 2; ++u)   // each lane's better key first
        if (kE == 2) {
          const bool swap = ahead(x[u][1], x[u][0]);
          const PKey lo = pick(swap, x[u][1], x[u][0]);
          x[u][1] = pick(swap, x[u][0], x[u][1]);
          x[u][0] = lo;
        }
      int taken[2] = {0, 0}, left[2] = {kqa, kqz};
      unsigned head[2] = {0u, 0u};
      bool tied[2] = {false, false};
      while ((left[0] > 0 && !tied[0]) || (left[1] > 0 && !tied[1])) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (left[u] == 0 || tied[u]) continue;
          const unsigned cur =
              taken[u] < kE ? (unsigned)((taken[u] ? x[u][1] : x[u][0]).k >> 32)
                            : 0u;
          const unsigned top = __reduce_max_sync(kFull, cur);
          const unsigned eq = __ballot_sync(kFull, cur == top);
          if (!head[u]) head[u] = top;
          if (__popc(eq) > left[u]) {
            tied[u] = true;
          } else {
            taken[u] += (eq >> lane) & 1u;
            left[u] -= __popc(eq);
          }
        }
      }
      const bool sorted = tied[0] || tied[1];   // warp-uniform
      if (sorted) sort_warp<kE>(x, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int qi = u ? qz : qa, kq = u ? kqz : kqa;
        if (kq == 0) continue;
        Cand* dst = cand + (size_t)(q0 + qi) * cap + off_of[qi];
        if (sorted) {    // the first kq
#pragma unroll
          for (int e = 0; e < kE; ++e)
            if (32 * e + lane < kq)
              dst[32 * e + lane] = Cand{x[u][e].k, x[u][e].r, 0};
        } else {         // each lane's taken keys, packed by a scan
          int at = taken[u];
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_up_sync(kFull, at, off);
            if (lane >= off) at += o;
          }
          at -= taken[u];
#pragma unroll
          for (int e = 0; e < kE; ++e)
            if (e < taken[u]) dst[at + e] = Cand{x[u][e].k, x[u][e].r, 0};
        }
        if (lane == 0) heads[(size_t)(q0 + qi) * ntiles + tile] = head[u];
      }
    }
  }

  // ---- 4. the last block of the query tile merges ------------------------
  __syncthreads();
  if (tid == 0)
    last = ticket::take(tickets + blockIdx.y) == ntiles - 1;
  __syncthreads();
  if (!last) return;

  // A warp merges queries warp and warp + kWarps.  A candidate under the
  // query's threshold cannot win: the heads of k tiles score at least as
  // high (the threshold is the k-th best of the lanes' best heads, each
  // lane's from other tiles).  When at most 64 candidates are left, and
  // k <= 64, they are sorted across the warp and the first k are the
  // answer; otherwise k rounds over every candidate.
  Cand* wbuf = reinterpret_cast<Cand*>(smem) + warp * 2 * 64;
  int total[2] = {0, 0}, kept[2] = {0, 0};
  unsigned th[2] = {0, 0};
  const Cand* src[2] = {cand + (size_t)(q0 + min(warp, nqt - 1)) * cap,
                        cand + (size_t)(q0 + min(warp + kWarps, nqt - 1)) *
                                   cap};
  // One round trip: both queries' counts, heads and first 256 candidates
  // (every load is issued, from a clamped address, and masked after: a
  // load under a branch would wait for the one before it).
  PKey x[2][8];
  unsigned h[2][8];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int qi = min(warp + u * kWarps, nqt - 1);
    total[u] = __ldcg(fill + q0 + qi);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      h[u][i] = __ldcg(heads + (size_t)(q0 + qi) * ntiles +
                       min(32 * i + lane, ntiles - 1));
      x[u][i] = load_cand(src[u] + min(32 * i + lane, (int)cap - 1));
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int qi = warp + u * kWarps;
    if (qi >= nqt) total[u] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (qi >= nqt || 32 * i + lane >= ntiles) h[u][i] = 0u;
#pragma unroll
    for (int i = 1; i < 8; ++i) h[u][0] = max(h[u][0], h[u][i]);
    for (int j = 256 + lane; qi < nqt && j < ntiles; j += 32)
      h[u][0] = max(h[u][0], __ldcg(heads + (size_t)(q0 + qi) * ntiles + j));
  }
  // the lanes' best heads, best first; the k-th is the threshold
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const bool best_side = ((lane & stride) == 0) == ((lane & size) == 0);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const unsigned o = __shfl_xor_sync(kFull, h[u][0], stride);
        h[u][0] = (o > h[u][0]) == best_side ? o : h[u][0];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
    if (k <= 32 && total[u] > 64) th[u] = __shfl_sync(kFull, h[u][0], k - 1);
  // the candidates at or over the threshold (the first 64) into wbuf: a
  // count and a scan across the warp for each 256
  for (int c0 = 0; c0 < max(total[0], total[1]); c0 += 8 * 32) {
    if (c0 > 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          x[u][i] = load_cand(src[u] + min(c0 + 32 * i + lane,
                                            max(total[u] - 1, 0)));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      bool keep[8];
      int mine = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        keep[i] = c0 + 32 * i + lane < total[u] &&
                  (unsigned)(x[u][i].k >> 32) >= th[u];
        mine += keep[i];
      }
      int at = mine;   // inclusive scan of the lanes' counts
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, at, off);
        if (lane >= off) at += o;
      }
      const int all = __shfl_sync(kFull, at, 31);
      at += kept[u] - mine;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (keep[i] && at < 64)
          wbuf[u * 64 + at] = Cand{x[u][i].k, x[u][i].r, 0};
        at += keep[i];
      }
      kept[u] += all;
    }
  }
  __syncwarp();
  PKey best[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int at = 32 * e + lane;
      const Cand y = wbuf[u * 64 + at];
      best[u][e] = at < min(kept[u], 64) ? PKey{y.k, y.r} : worst_packed();
    }
  if (k <= 32 && max(kept[0], kept[1]) <= 32)
    sort_warp<1>(best, lane);
  else
    sort_warp<2>(best, lane);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int qi = warp + u * kWarps, qg = q0 + qi;
    if (qi >= nqt) continue;
    // the k-th key must be a member ahead of every row outside
    const int kth = min(k, 64) - 1;
    const unsigned kth_s = (unsigned)(__shfl_sync(
        kFull, kth < 32 ? best[u][0].k : best[u][1].k, kth % 32) >> 32);
    const bool sorted = k <= 64 && kept[u] <= 64 && kept[u] >= k &&
                        (!kMasked || kth_s >= score_image(kNegInf));
    if (sorted) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (32 * e + lane < k) {
          out_v[(size_t)qg * k + 32 * e + lane] = score_of(best[u][e]);
          out_r[(size_t)qg * k + 32 * e + lane] = best[u][e].r;
        }
    } else {   // the general merge: every candidate, k rounds
      merge_rounds<kMasked>(
          cand + (size_t)qg * cap, total[u],
          kMasked ? virt + (size_t)qg * n : nullptr, n, k, lane,
          out_v + (size_t)qg * k, out_r + (size_t)qg * k);
    }
    if (lane == 0) fill[qg] = 0;
  }
  if (tid == 0) tickets[blockIdx.y] = 0;
}

inline int tile_rows(int n) { return n <= kSmallN ? 16 : 64; }

// bytes of the scratch a launch takes: the candidates, (Q, ntiles *
// min(k, kRows)), then the heads, (Q, ntiles); 0 for arguments launch
// refuses
inline size_t scratch_bytes(int n, int nq, int k) {
  if (n <= 0 || nq <= 0 || k <= 0 || k > n) return 0;
  const int rows = tile_rows(n);
  const size_t ntiles = ((size_t)n + rows - 1) / rows;
  return (size_t)nq * ntiles * (std::min(k, rows) * sizeof(Cand) + 4);
}

template <bool kMasked, int kRows>
int launch_rows(const float* emb, const float* q, const int* virt, int n,
                int d, int nq, int k, void* scratch, int* tickets,
                float* out_v, int* out_r, cudaStream_t stream) {
  constexpr int kBytes = Geo<kRows>::kBytes;
  const auto kernel = score_merge<kMasked, kRows>;
  // past the default 48 KB: the opt-in holds for the current card only, so
  // every launch sets it
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reset it, so the next launch does not report it
    return (int)err;
  }
  const int ntiles = (n + kRows - 1) / kRows;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0;
  Cand* cand = static_cast<Cand*>(scratch);
  unsigned* heads = reinterpret_cast<unsigned*>(
      cand + (size_t)nq * ntiles * std::min(k, kRows));
  kernel<<<dim3(ntiles, (nq + kQT - 1) / kQT), kThreads, kBytes, stream>>>(
      emb, q, virt, n, d, nq, k, vec, cand, heads, tickets, out_v, out_r);
  return (int)cudaGetLastError();
}

// The one launch, on `stream`.  emb (N, d) and q (Q, d) f32, row-major;
// virt (Q, N) int32, read only when kMasked; scratch: scratch_bytes(n, nq,
// k) bytes on a 16-byte boundary; tickets: `ntickets` >= ceil(Q / 16) + Q
// zeroed ints that no other launch uses at the same time (zero again when
// this one ends).  out_v / out_r: (Q, k).  Any d >= 1 and 1 <= k <= N.
// Returns a cudaError_t.
template <bool kMasked>
int launch(const float* emb, const float* q, const int* virt, int n, int d,
           int nq, int k, void* scratch, int* tickets, long long ntickets,
           float* out_v, int* out_r, cudaStream_t stream) {
  const long long nqtiles = ((long long)nq + kQT - 1) / kQT;
  if (n <= 0 || d <= 0 || nq <= 0 || k <= 0 || k > n ||
      nqtiles > kMaxQueryTiles || ntickets < nqtiles + nq ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return tile_rows(n) == 16
             ? launch_rows<kMasked, 16>(emb, q, virt, n, d, nq, k, scratch,
                                        tickets, out_v, out_r, stream)
             : launch_rows<kMasked, 64>(emb, q, virt, n, d, nq, k, scratch,
                                        tickets, out_v, out_r, stream);
}

}  // namespace tiled
}  // namespace topk
