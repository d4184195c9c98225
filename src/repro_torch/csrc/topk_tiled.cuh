// Masked and plain top-k in one launch: the scoring, selection and merge of
// the port's ivf_topk (K1) and of slab_topk in every mode -- fp32 (K2),
// fp16 and int8 with row scales (K3), and pq (K4).  Each call is one
// launch of score_merge<kMode, kRows>, with its merge inside.
//
// Grid: one block of 256 threads per (row tile, query tile).  A query tile
// holds up to 16 queries (the main path's 16 are one tile).  A row tile
// holds kRows rows, picked from N alone, in every mode: 16 rows while N <=
// 2,048 (the centroid probe's 125 rows spread over 8 blocks), 64 above (the
// fp32 slab's ~15,600 rows give ~245 blocks, two on each SM; the codec
// slabs' ~9,500 rows ~150).  pq keeps the same rule, not tuned apart:
// its width m only sets how many subspaces a stage holds (below), and its
// scoring is a small part of its time, so the height matters less there
// than the fixed chain of phases 1, 3 and 4.
//
//   1. Members (slab modes).  The block reads its (query tile, row tile)
//      slice of virt.  Row r competes for query q only when virt[q, r] <
//      kNotProbed, with tie key virt[q, r]; a row that no query of the tile
//      probes is never read, and a tile with no member reads no rows.  In
//      ivf_topk every row competes and the tie key is the row.  Each
//      query's count of candidates here, min(k, members), gets its offset
//      in the query's candidate array from an atomicAdd on the query's fill
//      counter, whose answer is needed only after the scoring; the queries
//      with members here, ascending, are the tile's active list.
//   2. Scoring, by mode (below).  Every (query, row) score is one fixed
//      computation that depends on D (or m) alone -- not on Q, N, the tile
//      height, the active list or where the row falls -- so a batch gives
//      bitwise the result of its queries run one at a time.
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
//      candidates under it, and up to kMergeCap of the rest go to shared
//      memory.  When at most 64 are left and k <= 64, they are sorted
//      across the warp (bitonic) and the first k are the answer.
//      Otherwise (and for slab_topk when fewer than k members score >=
//      kNegInf) k rounds of warp reductions over the lanes' heads: over
//      the kept candidates, each lane's column sorted in registers first so
//      that a round's winner moves to its next in one load, or, past
//      kMergeCap, over every candidate in scratch, the winner rescanning
//      its own.  The rows that do not compete -- key (kNegInf, kNotProbed,
//      row), so after every member scoring >= kNegInf, in row order -- are
//      found in virt when one can win a round.  The block then zeroes the
//      counters it used, so the next launch on the stream finds them 0;
//      the caller keeps one zeroed counter array per (card, stream).
// Selection is under one TOTAL order (score desc, tie key asc, row asc), so
// the best k of the union of per-tile candidates is the global best k
// whichever block merges, whatever order the atomics hand out, and a
// query's result does not depend on the other queries or on the tile
// heights.
//
// Scoring of the dense modes.  Rows and queries cross shared memory a
// slice of D at a time (so any D works: nothing holds a whole query), each
// row once per query tile, by 16-byte cp.async through kStages stages with
// mbarriers and no block barrier: every thread stages its share of a slice
// kStages - 1 ahead and arrives on the slice's `full` barrier when its
// copies land (cp.async.mbarrier.arrive); a consuming warp waits on `full`,
// computes, and arrives on `empty`, which the slice kStages later waits
// for.  A score is four FMA chains over the elements d = 0, 1, 2, 3 (mod
// 4), each in ascending d, then (c0 + c1) + (c2 + c3).
//   fp32 rows (K1, K2), 64 elements a slice.  16-row tiles: all 8 warps
//      compute, a query x a row a thread, 11 slices in flight (all of D =
//      768).  64-row tiles: warps 0-3 compute, 4 queries x 2 rows a thread,
//      while warps 4-7 only stage and run ahead.  A warp none of whose
//      pairs competes skips the FMAs.
//   fp16 and int8 rows (K3).  Rows are staged in their own type, 128
//      elements of D a slice -- 256 B a row-slice for fp16, 128 B for
//      int8, no f32 copy of the slab anywhere -- and the queries in f32;
//      only the active list's queries are staged, in its order.  A block
//      pays ~0.8 us a slice at 64 elements and ~1.3 at 128
//      (scripts/kernel_phases.py), so the slices are twice the f32 ones: at
//      the codec paths' call 64-element slices scored in 9.9 us (fp16) and
//      9.0 (int8), 128-element ones in 7.7 and 7.1, the call 0.0229 ->
//      0.0200 ms (fp16) and 0.0226 -> 0.0195 (int8) on an H100; 256-element
//      int8 slices (two stages) measured slower.  A thread computes one
//      row against 4 active queries (64-row tiles: warps 2g and 2g + 1
//      hold queries 4g..4g+3 of the list, 32 rows each) or 1 (16-row
//      tiles), so a tile whose rows only a few queries probe -- the codec
//      paths' case: a query probes 8 of 125 clusters, and a 64-row tile
//      holds one to three of them -- keeps two warps busy on 64 rows,
//      instead of one warp per fixed group of 4 query indices working
//      through every row.  Each thread
//      reads its row's 16 bytes (8 fp16 or 16 int8 elements) in one
//      conflict-free load (row pitches of 272 and 144 bytes) and widens them
//      in registers, exactly: fp16 by __half22float2 (HADD2.F32 on
//      sm_90a, cuobjdump), int8 by the bytes xor 0x80 placed under the
//      exponent of 2^23 (__byte_perm) less 2^23 + 128 -- a PRMT and an
//      FADD, where a cvt would take the quarter-rate conversion unit.  With
//      4 or fewer active queries (the codec paths' tiles) every element is
//      widened once per block; with more, once per group of 4.  Widening
//      here, not in a staging warp: at the codec paths' call an int8 tile
//      (half fp16's bytes, twice its widening instructions) scores in 8.8
//      us against fp16's 9.8 (scripts/kernel_phases.py, H100), so the
//      widening is not what sets the phase; the FMAs are part of it (the
//      1- and 2-query bodies below took ~2 us off it).  Then the same FMA
//      chains as fp32,
//      and int8 multiplies the finished score by the row's scale, rounded
//      once (__fmul_rn), as the TPU kernel scales its score tile.  So
//      slab_topk(e16, q, v, k) gives the bits of slab_topk(e16.float(), q,
//      v, k), and int8 with unit scales those of fp32 on e8.float().
//   Anything off the 16-byte path (an operand not on a 16-byte boundary, or
//   D not a multiple of 4 / 8 / 16 for fp32 / fp16 / int8) is staged into
//   the same tiles by plain loads, and gives the same bits.
// Scoring of pq (K4).  The score of (query, row) is acc = 0, then acc =
//   __fadd_rn(acc, luts[q, j, codes[r, j]]) for j ascending, the plain
//   version's order, so K4 is bitwise equal to it on any input.  A stage
//   holds kTabSlots tables of 256 floats: the tables of the active list's
//   queries only, S subspaces each, S the largest power of two <= 32 with S
//   x active <= kTabSlots -- the codec paths' tiles (m = 8, a few active
//   queries) stage every table they use, 8 KB a query, in one stage.  The
//   tile's codes cross shared memory 32 subspaces a chunk (4-byte cp.async,
//   or plain loads for m % 4 != 0).  Two stages and two chunks alternate
//   (cp.async groups, a block barrier a slice), so any m works.  A thread
//   takes one row against 4 (64-row tiles) or 1 (16-row tiles) of the
//   active queries, and gathers only for member pairs.  The gathers of a
//   warp hit one query's table at 32 random codes: ~3.5-way bank conflicts
//   on random codes, which nothing here avoids -- at the codec paths' shape
//   they are ~130 k gathers in all, and pq's scoring phase takes 1.8 us of
//   its 14 us call (scripts/kernel_phases.py, H100), where the members,
//   selection and the merge take the rest.
//
// What bounds it on this card: reading the member rows once (D x 4, 2 or 1
// bytes, or m bytes of codes), the queries or tables, and the (Q, N) virt
// matrix; at the codec paths' shapes a few MB, so the launch's latency and
// its chains (virt, then the rows, then selection and the merge) weigh as
// much as HBM's rate.
#pragma once

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

// STAMP(k): phase stamps with -DKERNEL_STAMPS; STAMP_COUNT counts the
// queries a block merged by k rounds over scratch
#include "stamps.cuh"
#include "ticket.cuh"

namespace topk {

constexpr float kNegInf = -1e30f;  // score of a masked row
constexpr int kNotProbed = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

struct Key {
  float s;  // score
  int t;    // tie key (row index for ivf_topk, virt for slab_topk)
  int r;    // row index
};

// after every real candidate
__device__ __forceinline__ Key worst() {
  return Key{-INFINITY, INT_MAX, INT_MAX};
}

namespace tiled {

// the modes: what a row is and how it scores
constexpr int kIvf = 0;   // f32 rows, every row competes (ivf_topk)
constexpr int kF32 = 1;   // f32 rows, masked by virt (slab_topk)
constexpr int kF16 = 2;   // fp16 rows
constexpr int kI8 = 3;    // int8 rows, times an f32 scale a row
constexpr int kPq = 4;    // uint8 codes against f32 tables

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 16;           // queries per query tile
constexpr int kDK = 64;           // elements of D a stage
constexpr int kPitch = kDK + 4;   // staged f32 row, floats (no conflicts)
constexpr int kSmallN = 2048;     // N up to this: 16-row tiles; above: 64
constexpr int kMaxQueryTiles = 65535;  // the grid's y extent
constexpr int kTabSlots = 32;     // pq: tables of 256 floats a stage
constexpr int kCC = 32;           // pq: subspaces of codes a chunk
constexpr int kCP = kCC + 4;      // pq: staged codes a row, bytes (odd words)
constexpr int kMergeCap = 256;    // candidates a query the merge keeps in smem
static_assert(kMergeCap == 32 * 8, "a lane's column is sort_column's 8");

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

// One launch's operands.  emb: (N, d) rows of the mode's type, or pq's (N,
// m) codes (d = m); q: (Q, d) f32 queries, or pq's (Q, m, 256) f32 tables;
// scales: int8's (N,) f32; virt: (Q, N) int32 (slab modes).  vec: the
// operands take the 16-byte path (pq: bit 0 the tables, bit 1 the codes
// by 4-byte copies).
struct Args {
  const void* emb;
  const float* q;
  const float* scales;
  const int* virt;
  int n, d, nq, k, vec;
  Cand* cand;
  unsigned* heads;
  int* tickets;
  float* out_v;
  int* out_r;
};

template <int kMode, int kRows>
struct Geo {
  static constexpr bool kSmall = kRows == 16;
  static constexpr bool kF32Rows = kMode == kIvf || kMode == kF32;
  static constexpr bool kPQ = kMode == kPq;
  static constexpr int kElem = kMode == kF16 ? 2 : kMode == kI8 ? 1 : 4;
  static constexpr int kEPL = 16 / kElem;   // row elements a 16-byte copy
  // f32 rows: 16-row tiles, all 8 warps compute (a query x a row a
  // thread); 64-row tiles, warps 0-3 (4 queries x 2 rows a thread) while
  // warps 4-7 only stage, so they run ahead of the FMAs.  fp16 / int8
  // rows: every warp computes, a row against kQPT active queries a thread.
  static constexpr int kComputeWarps = kF32Rows && !kSmall ? 4 : kWarps;
  static constexpr int kRW = kSmall ? 16 : 32;  // rows across a warp's lanes
  static constexpr int kSub = 32 / kRW;         // query sets within a warp
  static constexpr int kRowBlocks = kF32Rows ? 1 : kRows / kRW;
  static constexpr int kRPT = kF32Rows ? kRows / kRW : 1;  // rows a thread
  static constexpr int kQPT =
      kQT * kRowBlocks / (kComputeWarps * kSub);          // queries a thread
  // elements of D a slice: 64 for f32 rows, 128 for fp16 / int8 rows
  static constexpr int kSlice = kF32Rows || kPQ ? kDK : 2 * kDK;
  static constexpr int kQPitch = kSlice + 4;    // staged query, floats
  static constexpr int kRowPitch =                         // bytes a row
      kF32Rows ? kPitch * 4 : kSlice * kElem + 16;
  static constexpr int kStages =
      kPQ ? 2 : kF32Rows ? (kSmall ? 12 : 4)
          : kSmall ? 6 : kMode == kF16 ? 3 : 4;
  static constexpr int kStageBytes =
      kPQ ? kTabSlots * 256 * 4 : kRows * kRowPitch + kQT * kQPitch * 4;
  static constexpr int kStageArea =
      kStages * kStageBytes + (kPQ ? 2 * kRows * kCP : 0);
  // stages, then the (kQT, kRows) scores and tie keys; the merge reuses it
  static constexpr int kBytes = kStageArea + 2 * kQT * kRows * 4;

  static_assert(kPQ || kQPT * kComputeWarps * kSub == kQT * kRowBlocks,
                "the compute warps must cover the (query, row) tile");
  static_assert(kStageArea % 16 == 0 && kRowPitch % 16 == 0,
                "staged rows and the scores on 16-byte boundaries");
  static_assert(kQT <= 2 * kWarps, "a warp merges at most two queries");
  static_assert(kWarps * 2 * kMergeCap * (int)sizeof(Cand) <= kBytes,
                "room for the merge's kept candidates");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes, or 16 zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
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

// the total order without branches (a warp's lanes compare different keys):
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

// Sorts 8 keys best first in registers (Batcher's odd-even merge network,
// 19 compare-exchanges).
__device__ __forceinline__ void sort_column(PKey (&c)[8]) {
  constexpr int kNet[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2},
                               {1, 3}, {4, 6}, {5, 7}, {1, 2}, {5, 6},
                               {0, 4}, {3, 7}, {1, 5}, {2, 6}, {1, 4},
                               {3, 6}, {2, 4}, {3, 5}, {3, 4}};
#pragma unroll
  for (int i = 0; i < 19; ++i) {
    const int a = kNet[i][0], b = kNet[i][1];
    const bool swap = ahead(c[b], c[a]);
    const PKey lo = pick(swap, c[b], c[a]);
    c[b] = pick(swap, c[a], c[b]);
    c[a] = lo;
  }
}

// a candidate written by another block: read through L2
__device__ __forceinline__ PKey load_cand(const Cand* p) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
  return PKey{((unsigned long long)(unsigned)v.y << 32) | (unsigned)v.x,
              v.z};
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

// The merge of one query by one warp in k rounds: the best k of its
// candidates and, when kMasked, of the rows outside it (vrow: its virt
// row).  Each round takes the best of the lanes' heads; head_after(prev,
// first) gives a lane its next head (its best candidate after prev).
template <bool kMasked, class Next>
__device__ void merge_rounds(const Next& head_after, const int* vrow, int n,
                             int k, int lane, float* out_v, int* out_r) {
  Key head = head_after(worst(), true), outsider = worst();
  int from = 0;
  bool found = false;
  for (int i = 0; i < k; ++i) {
    // the best of the lanes' heads: (score, tie key) is unique among the
    // candidates, so two reductions find its lane, which writes it
    const unsigned hi = score_image(head.s), lo = ~int_image(head.t);
    const unsigned top = __reduce_max_sync(kFull, hi);
    const unsigned top_lo = __reduce_max_sync(kFull, hi == top ? lo : 0u);
    const int w = __ffs(__ballot_sync(kFull, hi == top && lo == top_lo)) - 1;
    bool member = true;
    if constexpr (kMasked) {
      if (!(score_of(PKey{(unsigned long long)top << 32, 0}) >= kNegInf)) {
        // a row outside may come first
        if (!found) {
          outsider = next_outsider(vrow, n, from, lane);
          found = true;
        }
        const Key best{__shfl_sync(kFull, head.s, w),
                       __shfl_sync(kFull, head.t, w),
                       __shfl_sync(kFull, head.r, w)};
        if (ahead(outsider, best)) {
          member = false;
          from = outsider.r + 1;
          found = false;
          if (lane == 0) {
            out_v[i] = outsider.s;
            out_r[i] = outsider.r;
          }
        }
      }
    }
    if (member && lane == w) {
      out_v[i] = head.s;
      out_r[i] = head.r;
      head = head_after(head, false);
    }
  }
}

// What a block's scoring takes from phase 1.
struct Tile {
  int tid, lane, warp, row0, rows, q0, nqt, n_with;
  const int* with_kq;   // the active list: tile queries with members here
  const bool* row_on;   // (kRows,) some query of the tile probes the row
  const int* vt;        // (kQT, kRows) tie keys; kNotProbed: no member
  float* sc;            // (kQT, kRows) scores, written for member pairs
};

template <bool kMasked, int kRows>
__device__ __forceinline__ bool is_member(const Tile& t, int qi, int c) {
  if constexpr (kMasked)
    return t.vt[qi * kRows + c] < kNotProbed;
  else
    return qi < t.nqt && c < t.rows;
}

// 16 bytes of row elements to f32, exactly: 8 fp16 ...
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// ... or 16 int8: byte b + 128 under the exponent of 2^23 is the float
// 2^23 + b + 128, and the subtraction is exact
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[16]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[4 * i + b] =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | b)) -
          8388736.f;
  }
}

// The dense modes' slice pipeline, without block barriers: every thread
// stages its share of each slice (stage(s, st): its copies of slice s into
// stage st) kStages - 1 slices ahead and arrives on the stage's `full`
// barrier when they land (cp.async.mbarrier.arrive when `async`); a
// computing warp waits on `full`, consumes the slice (consume(s, st)), and
// arrives on its `empty` barrier, which the stagers of the slice kStages
// later wait for.  Warps that do not compute stage ahead without waiting
// for the FMAs.
template <int kStages, class Stage, class Consume>
__device__ __forceinline__ void pipeline(int slices, bool computes,
                                         bool async, int lane,
                                         uint64_t* full, uint64_t* empty,
                                         const Stage& stage,
                                         const Consume& consume) {
  constexpr int kAhead = kStages - 1;   // slices in flight
  auto put = [&](int s) {
    const int st = s % kStages;
    if (s >= kStages)   // its stage's previous slice is consumed
      mbar_wait(&empty[st], (s / kStages - 1) & 1);
    stage(s, st);
    if (async)
      mbar_arrive_copies(&full[st]);
    else
      mbar_arrive(&full[st]);
  };
  for (int s = 0; s < kAhead && s < slices; ++s) put(s);
  if (!computes) {
    for (int s = kAhead; s < slices; ++s) put(s);
    return;
  }
  for (int s = 0; s < slices; ++s) {
    const int st = s % kStages;
    mbar_wait(&full[st], (s / kStages) & 1);
    consume(s, st);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (s + kAhead < slices) put(s + kAhead);
  }
}

// Phase 2, f32 rows (K1, K2): a thread's kQPT queries x kRPT rows.
template <int kMode, int kRows>
__device__ __forceinline__ void score_f32(const Args& a, const Tile& t,
                                          char* smem_bytes, uint64_t* full,
                                          uint64_t* empty) {
  using G = Geo<kMode, kRows>;
  constexpr bool kMasked = kMode != kIvf;
  constexpr int kStageFloats = G::kStageBytes / 4;
  float* smem = reinterpret_cast<float*>(smem_bytes);
  const float* emb = static_cast<const float*>(a.emb);
  const int d = a.d;
  const bool computes = t.warp < G::kComputeWarps;
  const int lr = t.lane % G::kRW;                     // rows lr + kRW i
  const int qb = (t.warp * G::kSub + t.lane / G::kRW) * G::kQPT;
  bool mine = false;
#pragma unroll
  for (int j = 0; j < G::kQPT; ++j)
#pragma unroll
    for (int i = 0; i < G::kRPT; ++i)
      mine |= computes &&
              is_member<kMasked, kRows>(t, qb + j, lr + G::kRW * i);
  const bool warp_on = __any_sync(kFull, mine);

  // Thread tid's share of slice `slice`: the member rows and the queries
  // (columns past d are zeros, so they add exact zeros).
  auto stage = [&](int slice, int st) {
    float* dst = smem + st * kStageFloats;
    const int d0 = slice * kDK;
    if (a.vec) {
      constexpr int kPer = kDK / 4;   // 16-byte copies a staged row
      for (int c = t.tid; c < (kRows + kQT) * kPer; c += kThreads) {
        const int rr = c / kPer, e = (c - rr * kPer) * 4;
        if (rr < kRows ? !t.row_on[rr] : rr - kRows >= t.nqt) continue;
        const float* src = rr < kRows
                               ? emb + (size_t)(t.row0 + rr) * d
                               : a.q + (size_t)(t.q0 + rr - kRows) * d;
        const bool ok = d0 + e < d;
        cp_async16(dst + rr * kPitch + e, ok ? src + d0 + e : src, ok);
      }
    } else {
      for (int c = t.tid; c < (kRows + kQT) * kDK; c += kThreads) {
        const int rr = c / kDK, e = c - rr * kDK;
        if (rr < kRows ? !t.row_on[rr] : rr - kRows >= t.nqt) continue;
        const float* src = rr < kRows
                               ? emb + (size_t)(t.row0 + rr) * d
                               : a.q + (size_t)(t.q0 + rr - kRows) * d;
        dst[rr * kPitch + e] = d0 + e < d ? src[d0 + e] : 0.f;
      }
    }
  };
  float acc[G::kQPT][G::kRPT][4] = {};
  auto consume = [&](int, int st) {
    if (!warp_on) return;
    const float* rp = smem + st * kStageFloats + lr * kPitch;
    const float* qp = smem + st * kStageFloats + (kRows + qb) * kPitch;
#pragma unroll
    for (int e = 0; e < kDK; e += 4) {
      float4 x[G::kRPT];
#pragma unroll
      for (int i = 0; i < G::kRPT; ++i)
        x[i] = *reinterpret_cast<const float4*>(rp + G::kRW * i * kPitch + e);
#pragma unroll
      for (int j = 0; j < G::kQPT; ++j) {
        const float4 y = *reinterpret_cast<const float4*>(qp + j * kPitch + e);
#pragma unroll
        for (int i = 0; i < G::kRPT; ++i) {
          acc[j][i][0] = fmaf(x[i].x, y.x, acc[j][i][0]);
          acc[j][i][1] = fmaf(x[i].y, y.y, acc[j][i][1]);
          acc[j][i][2] = fmaf(x[i].z, y.z, acc[j][i][2]);
          acc[j][i][3] = fmaf(x[i].w, y.w, acc[j][i][3]);
        }
      }
    }
  };
  pipeline<G::kStages>((d + kDK - 1) / kDK, computes, a.vec, t.lane, full,
                       empty, stage, consume);
  if (warp_on) {
#pragma unroll
    for (int j = 0; j < G::kQPT; ++j)
#pragma unroll
      for (int i = 0; i < G::kRPT; ++i)
        t.sc[(qb + j) * kRows + lr + G::kRW * i] =
            (acc[j][i][0] + acc[j][i][1]) + (acc[j][i][2] + acc[j][i][3]);
  }
}

// Phase 2, fp16 / int8 rows (K3): a thread's row against kQPT queries of
// the active list, the rows widened in registers, then score_f32's
// arithmetic.
template <int kMode, int kRows>
__device__ __forceinline__ void score_compact(const Args& a, const Tile& t,
                                              char* smem, uint64_t* full,
                                              uint64_t* empty) {
  using G = Geo<kMode, kRows>;
  using Raw = std::conditional_t<kMode == kF16, uint16_t, uint8_t>;
  constexpr int kEPL = G::kEPL;
  const char* emb = static_cast<const char*>(a.emb);
  const int d = a.d;
  const int lr = t.lane % G::kRW + G::kRW * (t.warp % G::kRowBlocks);
  const int sb =    // the first of this thread's kQPT slots in the list
      ((t.warp / G::kRowBlocks) * G::kSub + t.lane / G::kRW) * G::kQPT;
  bool mine = false;
#pragma unroll
  for (int j = 0; j < G::kQPT; ++j)
    mine |= sb + j < t.n_with &&
            t.vt[t.with_kq[sb + j] * kRows + lr] < kNotProbed;
  const bool warp_on = __any_sync(kFull, mine);

  // Thread tid's share of slice `slice`: the member rows in their own type
  // and the active queries in f32 (zeros past d).
  auto stage = [&](int slice, int st) {
    char* dst = smem + st * G::kStageBytes;
    float* qdst = reinterpret_cast<float*>(dst + kRows * G::kRowPitch);
    const int d0 = slice * G::kSlice;
    if (a.vec) {
      constexpr int kRC = G::kSlice / kEPL;   // 16-byte copies a row
      constexpr int kQC = G::kSlice / 4;      // ... a query
      const int total = kRows * kRC + t.n_with * kQC;
      for (int c = t.tid; c < total; c += kThreads) {
        if (c < kRows * kRC) {
          const int rr = c / kRC, e = (c - rr * kRC) * kEPL;
          if (!t.row_on[rr]) continue;
          const bool ok = d0 + e < d;
          cp_async16(dst + rr * G::kRowPitch + e * G::kElem,
                     ok ? emb + ((size_t)(t.row0 + rr) * d + d0 + e) *
                                    G::kElem
                        : emb,
                     ok);
        } else {
          const int cq = c - kRows * kRC, slot = cq / kQC;
          const int e = (cq - slot * kQC) * 4;
          const bool ok = d0 + e < d;
          cp_async16(qdst + slot * G::kQPitch + e,
                     ok ? a.q + (size_t)(t.q0 + t.with_kq[slot]) * d + d0 + e
                        : a.q,
                     ok);
        }
      }
    } else {
      const Raw* rows = static_cast<const Raw*>(a.emb);
      for (int c = t.tid; c < kRows * G::kSlice; c += kThreads) {
        const int rr = c / G::kSlice, e = c - rr * G::kSlice;
        if (!t.row_on[rr]) continue;
        reinterpret_cast<Raw*>(dst + rr * G::kRowPitch)[e] =
            d0 + e < d ? rows[(size_t)(t.row0 + rr) * d + d0 + e] : Raw(0);
      }
      for (int c = t.tid; c < t.n_with * G::kSlice; c += kThreads) {
        const int slot = c / G::kSlice, e = c - slot * G::kSlice;
        qdst[slot * G::kQPitch + e] =
            d0 + e < d ? a.q[(size_t)(t.q0 + t.with_kq[slot]) * d + d0 + e]
                       : 0.f;
      }
    }
  };
  // One slice of FMAs for this thread's first kN queries.  With 64-row
  // tiles a warp's slots are warp-uniform, so a warp with 1 or 2 active
  // queries runs the 1- or 2-query body, not the 4-query one (measured:
  // ~2 us less scoring at the codec paths' call, PERF.md).
  float acc[G::kQPT][4] = {};
  auto fmas = [&](const char* rp, const float* qp, auto n_c) {
    constexpr int kN = decltype(n_c)::value;
#pragma unroll
    for (int e = 0; e < G::kSlice; e += kEPL) {
      float x[kEPL];
      widen(*reinterpret_cast<const uint4*>(rp + e * G::kElem), x);
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int f = 0; f < kEPL; f += 4) {
          const float4 y =
              *reinterpret_cast<const float4*>(qp + j * G::kQPitch + e + f);
          acc[j][0] = fmaf(x[f], y.x, acc[j][0]);
          acc[j][1] = fmaf(x[f + 1], y.y, acc[j][1]);
          acc[j][2] = fmaf(x[f + 2], y.z, acc[j][2]);
          acc[j][3] = fmaf(x[f + 3], y.w, acc[j][3]);
        }
    }
  };
  const int nj = t.n_with - sb;   // this thread's active slots, if < kQPT
  auto consume = [&](int, int st) {
    if (!warp_on) return;
    const char* rp = smem + st * G::kStageBytes + lr * G::kRowPitch;
    const float* qp = reinterpret_cast<const float*>(
                          smem + st * G::kStageBytes + kRows * G::kRowPitch) +
                      sb * G::kQPitch;
    if constexpr (G::kQPT == 4) {
      if (nj == 1)
        fmas(rp, qp, std::integral_constant<int, 1>());
      else if (nj == 2)
        fmas(rp, qp, std::integral_constant<int, 2>());
      else
        fmas(rp, qp, std::integral_constant<int, 4>());
    } else {
      fmas(rp, qp, std::integral_constant<int, G::kQPT>());
    }
  };
  pipeline<G::kStages>((d + G::kSlice - 1) / G::kSlice, true, a.vec, t.lane,
                       full, empty, stage, consume);
  if (warp_on) {
#pragma unroll
    for (int j = 0; j < G::kQPT; ++j) {
      if (sb + j >= t.n_with) break;
      const int qi = t.with_kq[sb + j];
      if (t.vt[qi * kRows + lr] >= kNotProbed) continue;
      float s = (acc[j][0] + acc[j][1]) + (acc[j][2] + acc[j][3]);
      if constexpr (kMode == kI8)
        s = __fmul_rn(s, __ldg(a.scales + t.row0 + lr));
      t.sc[qi * kRows + lr] = s;
    }
  }
}

// Phase 2, pq (K4): a thread's row against kQPT queries of the active
// list, gathers and adds in ascending j.
template <int kRows>
__device__ __forceinline__ void score_pq(const Args& a, const Tile& t,
                                         char* smem) {
  using G = Geo<kPq, kRows>;
  constexpr int kStride = kThreads / kRows;   // list slots between queries
  constexpr int kQPT = kQT / kStride;
  const uint8_t* codes = static_cast<const uint8_t*>(a.emb);
  const int m = a.d;
  float* tabs = reinterpret_cast<float*>(smem);            // 2 stages
  uint8_t* cbuf = reinterpret_cast<uint8_t*>(              // 2 code chunks
      smem + G::kStages * G::kStageBytes);
  const int lr = t.tid % kRows, sb = t.tid / kRows;
  int S = kCC;   // subspaces a slice: every active table fits a stage
  while (S > 1 && S * t.n_with > kTabSlots) S >>= 1;
  const int slices = (m + S - 1) / S;

  // slice s's tables into stage s & 1 and, where it starts a chunk, the
  // chunk's codes; one cp.async group
  auto fetch = [&](int s) {
    const int j0 = s * S, nj = min(S, m - j0);
    if (j0 % kCC == 0) {
      uint8_t* dst = cbuf + ((j0 / kCC) & 1) * kRows * kCP;
      const int nb = min(kCC, m - j0);
      if (a.vec & 2) {
        const int nw = (nb + 3) >> 2;
        for (int c = t.tid; c < kRows * nw; c += kThreads) {
          const int rr = c / nw, w = c - rr * nw;
          if (t.row_on[rr])
            cp_async4(dst + rr * kCP + 4 * w,
                      codes + (size_t)(t.row0 + rr) * m + j0 + 4 * w);
        }
      } else {
        for (int c = t.tid; c < kRows * nb; c += kThreads) {
          const int rr = c / nb, b = c - rr * nb;
          if (t.row_on[rr])
            dst[rr * kCP + b] = codes[(size_t)(t.row0 + rr) * m + j0 + b];
        }
      }
    }
    float* dst = tabs + (s & 1) * kTabSlots * 256;
    const int per = nj * 256;   // floats of a query's slice
    if (a.vec & 1) {
      for (int c = t.tid; c < t.n_with * (per >> 2); c += kThreads) {
        const int slot = c / (per >> 2), o = (c - slot * (per >> 2)) * 4;
        cp_async16(dst + slot * S * 256 + o,
                   a.q + ((size_t)(t.q0 + t.with_kq[slot]) * m + j0) * 256 +
                       o,
                   true);
      }
    } else {
      for (int c = t.tid; c < t.n_with * per; c += kThreads) {
        const int slot = c / per, o = c - slot * per;
        cp_async4(dst + slot * S * 256 + o,
                  a.q + ((size_t)(t.q0 + t.with_kq[slot]) * m + j0) * 256 +
                      o);
      }
    }
    cp_async_commit();
  };

  fetch(0);
  float acc[kQPT] = {};
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {   // the next slice lands while this one adds up
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = s * S, nj = min(S, m - j0);
    const float* tb = tabs + (s & 1) * kTabSlots * 256;
    const uint8_t* cr =
        cbuf + ((j0 / kCC) & 1) * kRows * kCP + lr * kCP + j0 % kCC;
#pragma unroll
    for (int i = 0; i < kQPT; ++i) {
      const int slot = sb + i * kStride;
      if (slot < t.n_with &&
          t.vt[t.with_kq[slot] * kRows + lr] < kNotProbed) {
        const float* tq = tb + slot * S * 256;
#pragma unroll 8
        for (int j = 0; j < nj; ++j)
          acc[i] = __fadd_rn(acc[i], tq[j * 256 + cr[j]]);
      }
    }
    __syncthreads();   // stage s & 1 and its chunk are free again
  }
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int slot = sb + i * kStride;
    if (slot < t.n_with) {
      const int qi = t.with_kq[slot];
      if (t.vt[qi * kRows + lr] < kNotProbed) t.sc[qi * kRows + lr] = acc[i];
    }
  }
}

// candidates: (Q, cap) in a.cand, cap = ntiles * min(k, kRows); a.heads:
// (Q, ntiles) score images of each tile's best candidate (0: none);
// a.tickets: the query tiles' counters, then the queries' fill counters,
// all zero, zero again when the launch ends.
template <int kMode, int kRows>
__global__ void __launch_bounds__(kThreads, 2) score_merge(const Args a) {
  using G = Geo<kMode, kRows>;
  constexpr bool kMasked = kMode != kIvf;
  constexpr int kBars = G::kPQ ? 1 : G::kStages;
  extern __shared__ __align__(16) char smem[];
  float* sc = reinterpret_cast<float*>(smem + G::kStageArea);  // (kQT, kRows)
  int* vt = reinterpret_cast<int*>(sc + kQT * kRows);          // (kQT, kRows)
  __shared__ __align__(8) uint64_t full[kBars], empty[kBars];
  __shared__ bool row_on[kRows];
  __shared__ int kq_of[kQT], off_of[kQT], with_kq[kQT], n_with, last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n, k = a.k;
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int row0 = tile * kRows, rows = min(kRows, n - row0);
  const int nqtiles = (a.nq + kQT - 1) / kQT;
  const int q0 = blockIdx.y * kQT, nqt = min(kQT, a.nq - q0);
  const size_t cap = (size_t)ntiles * min(k, kRows);
  const int* virt = a.virt;
  Cand* cand = a.cand;
  unsigned* heads = a.heads;
  int* tickets = a.tickets;
  float* out_v = a.out_v;
  int* out_r = a.out_r;
  int* fill = tickets + nqtiles;                          // (Q,)
  STAMP(0);
  STAMP_SM();
  if (!G::kPQ && tid == 0) {
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
  // (the atomic's answer is read only after the scoring, so nothing waits
  // for it before), and the active list: the queries that have any
  int off = 0;
  if (warp == 0) {
    int kq = 0;
    if (lane < nqt) {
      int m = 0;
      for (int c = 0; c < kRows; ++c) m += member(lane, c);
      kq = min(k, m);
      kq_of[lane] = kq;
      if (kq) off = atomicAdd(fill + q0 + lane, kq);
      else heads[(size_t)(q0 + lane) * ntiles + tile] = 0;
    }
    const unsigned has = __ballot_sync(kFull, kq > 0);
    if (kq > 0) with_kq[__popc(has & ((1u << lane) - 1))] = lane;
    if (lane == 0) n_with = __popc(has);
  }

  // ---- 2. scoring ---------------------------------------------------------
  const bool any_on = __syncthreads_or(tid < kRows && row_on[tid]);
  STAMP(1);
  if (any_on) {
    const Tile t{tid, lane, warp, row0, rows, q0, nqt, n_with,
                 with_kq, row_on, vt, sc};
    if constexpr (G::kF32Rows)
      score_f32<kMode, kRows>(a, t, smem, full, empty);
    else if constexpr (G::kPQ)
      score_pq<kRows>(a, t, smem);
    else
      score_compact<kMode, kRows>(a, t, smem, full, empty);
  }

  if (warp == 0 && lane < nqt) off_of[lane] = off;

  // ---- 3. the tile's best min(k, members) rows of each query ------------
  // A warp takes two of the queries that have members here (non-members
  // hold the worst key) and writes each one's best kq.
  __syncthreads();
  STAMP(2);
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
  STAMP(3);
  if (tid == 0)
    last = ticket::take(tickets + blockIdx.y) == ntiles - 1;
  __syncthreads();
  if (!last) return;
  STAMP(4);

  // A warp merges queries warp and warp + kWarps.  A candidate under the
  // query's threshold cannot win: the heads of k tiles score at least as
  // high (the threshold is the k-th best of the lanes' best heads, each
  // lane's from other tiles).  The candidates left go to shared memory
  // (up to kMergeCap a query).  When at most 64 are left, and k <= 64,
  // they are sorted across the warp and the first k are the answer; when
  // at most kMergeCap, k rounds over them there; otherwise k rounds over
  // every candidate in scratch.
  Cand* wbuf = reinterpret_cast<Cand*>(smem) + warp * 2 * kMergeCap;
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
  // the candidates at or over the threshold (the first kMergeCap) into
  // wbuf: a
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
        if (keep[i] && at < kMergeCap)
          wbuf[u * kMergeCap + at] = Cand{x[u][i].k, x[u][i].r, 0};
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
      const Cand y = wbuf[u * kMergeCap + at];
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
    } else if (kept[u] <= kMergeCap) {
      // k rounds over the kept ones: each lane's column (candidates lane,
      // lane + 32, ...) sorted best first, so a round's winner only moves
      // to its next
      Cand* kb = wbuf + u * kMergeCap;
      constexpr int kCol = kMergeCap / 32;
      PKey col[kCol];
#pragma unroll
      for (int j = 0; j < kCol; ++j)
        col[j] = 32 * j + lane < kept[u]
                     ? PKey{kb[32 * j + lane].k, kb[32 * j + lane].r}
                     : worst_packed();
      sort_column(col);
#pragma unroll
      for (int j = 0; j < kCol; ++j)
        kb[32 * j + lane] = Cand{col[j].k, col[j].r, 0};
      const int mine = max(kept[u] - lane + 31, 0) / 32;   // real ones
      int next = 0;
      merge_rounds<kMasked>(
          [&](const Key&, bool) {
            if (next == mine) return worst();
            const Cand y = kb[32 * next++ + lane];
            return unpack(PKey{y.k, y.r});
          },
          kMasked ? virt + (size_t)qg * n : nullptr, n, k, lane,
          out_v + (size_t)qg * k, out_r + (size_t)qg * k);
    } else {   // every candidate in scratch: a lane rescans its own
      STAMP_COUNT();
      const Cand* gb = cand + (size_t)qg * cap;
      const int all = total[u];
      merge_rounds<kMasked>(
          [&](const Key& prev, bool first) {
            Key h = worst();
#pragma unroll 4
            for (int c = lane; c < all; c += 32) {
              const Key x = unpack(load_cand(gb + c));
              h = pick((first | ahead(prev, x)) & ahead(x, h), x, h);
            }
            return h;
          },
          kMasked ? virt + (size_t)qg * n : nullptr, n, k, lane,
          out_v + (size_t)qg * k, out_r + (size_t)qg * k);
    }
    if (lane == 0) fill[qg] = 0;
  }
  if (tid == 0) tickets[blockIdx.y] = 0;
  STAMP(5);
  STAMP_SYNC(6);   // every warp's merge done
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

template <int kMode, int kRows>
int launch_rows(Args a, cudaStream_t stream) {
  constexpr int kBytes = Geo<kMode, kRows>::kBytes;
  const auto kernel = score_merge<kMode, kRows>;
  // past the default 48 KB: the opt-in holds for the current card only, so
  // every launch sets it
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reset it, so the next launch does not report it
    return (int)err;
  }
  const int ntiles = (a.n + kRows - 1) / kRows;
  a.heads = reinterpret_cast<unsigned*>(
      a.cand + (size_t)a.nq * ntiles * std::min(a.k, kRows));
  kernel<<<dim3(ntiles, (a.nq + kQT - 1) / kQT), kThreads, kBytes, stream>>>(
      a);
  return (int)cudaGetLastError();
}

// The one launch, on `stream`.  emb: (N, d) rows of the mode's type, or
// pq's (N, m) uint8 codes with d = m; q: (Q, d) f32 queries, or pq's (Q, m,
// 256) f32 tables; scales: int8's (N,) f32, else ignored; virt: (Q, N)
// int32, ignored by kIvf; all row-major.  scratch: scratch_bytes(n, nq, k)
// bytes on a 16-byte boundary; tickets: `ntickets` >= ceil(Q / 16) + Q
// zeroed ints that no other launch uses at the same time (zero again when
// this one ends).  out_v / out_r: (Q, k).  Any d >= 1 and 1 <= k <= N.
// Returns a cudaError_t.
template <int kMode>
int launch(const void* emb, const float* q, const float* scales,
           const int* virt, int n, int d, int nq, int k, void* scratch,
           int* tickets, long long ntickets, float* out_v, int* out_r,
           cudaStream_t stream) {
  const long long nqtiles = ((long long)nq + kQT - 1) / kQT;
  if (n <= 0 || d <= 0 || nq <= 0 || k <= 0 || k > n ||
      nqtiles > kMaxQueryTiles || ntickets < nqtiles + nq ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      (kMode != kIvf && virt == nullptr) || (kMode == kI8 && !scales))
    return (int)cudaErrorInvalidValue;
  const uintptr_t pe = reinterpret_cast<uintptr_t>(emb);
  const uintptr_t pq = reinterpret_cast<uintptr_t>(q);
  int vec;
  if constexpr (kMode == kPq)
    vec = (pq % 16 == 0) | (d % 4 == 0 && pe % 4 == 0) << 1;
  else
    vec = d % Geo<kMode, 64>::kEPL == 0 && pe % 16 == 0 && pq % 16 == 0;
  const Args a{emb, q, scales, virt, n, d, nq, k, vec,
               static_cast<Cand*>(scratch), nullptr, tickets, out_v, out_r};
  return tile_rows(n) == 16 ? launch_rows<kMode, 16>(a, stream)
                            : launch_rows<kMode, 64>(a, stream);
}

}  // namespace tiled
}  // namespace topk
