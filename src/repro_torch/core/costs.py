"""Edge cost model + latency accounting.

This container is CPU-only, so the paper's *absolute* numbers (Jetson Orin
Nano: 8 GB shared DRAM, SD-card storage, iGPU embedding model) are reproduced
through a calibrated cost model; the *algorithms* (what gets stored, cached,
evicted, regenerated) always run for real.  Every retrieval returns a
:class:`LatencyBreakdown` carrying both the simulated edge seconds and the
measured wall seconds of the real computation.

Calibration (paper §3.2, Fig. 4): generating embeddings for clusters smaller
than ~24 000 chars (~8 000 tokens) beats loading them from storage.  With the
gte-base throughput below (~60 k chars/s on the Orin iGPU), the 24 k-char
cluster generates in ~0.40 s; the same cluster's embeddings (~80 chunks ×
3 072 B) must therefore take ~0.40 s to load, giving the effective scattered-
read bandwidth of ~0.6 MB/s (4 KiB random reads on a UHS-I SD card under
memory pressure — the paper's "thrashing" regime).  Sequential DRAM loads are
modeled at LPDDR5 speeds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

BYTES_PER_EMBEDDING_F32 = 768 * 4


@dataclasses.dataclass
class EdgeCostModel:
    # embedding generation (gte-base-en-v1.5 on the Orin iGPU)
    embed_chars_per_sec: float = 60_000.0
    embed_fixed_s: float = 0.008
    # SD-card storage: SEQUENTIAL reads (EdgeRAG's contiguously-stored heavy
    # clusters) vs RANDOM 4K reads (page-in thrashing of a scattered index —
    # this is the regime behind Fig. 4's ~24 kchar gen-vs-load break-even)
    storage_seq_bw_bytes_per_sec: float = 80e6
    storage_rand_bw_bytes_per_sec: float = 0.6e6
    storage_seek_s: float = 0.005
    # in-memory index access
    dram_bw_bytes_per_sec: float = 34e9          # LPDDR5-4250 x4
    # memory budget: the generation model + runtime stay resident, so the
    # INDEX has device_memory - model_reserved to work with before thrashing
    device_memory_bytes: float = 8 * 1024**3
    model_reserved_bytes: float = 6.0e9          # 5.4 GB LLM bf16 + runtime
    # vector math throughput for similarity search (CPU+GPU)
    search_flops_per_sec: float = 2.0e11
    # int8/fp16 storage codecs dequantize on load (widen + scale per value)
    dequant_values_per_sec: float = 2.0e9
    # fused in-kernel dequant (packed-slab scoring): the widen rides the
    # score matmul's data stream and the int8 per-row scale is applied to
    # the (Q, N) score block, not the (N, D) slab — far cheaper per value
    # than a standalone decode pass that materializes an fp32 copy
    fused_dequant_values_per_sec: float = 8.0e9
    # PQ slab scoring charges LUT build + code gather INSTEAD of dequant:
    # a row's score is m table lookups + adds (random access, no SIMD
    # stream), well below the fused-dequant rate
    pq_lookup_values_per_sec: float = 4.0e9
    # LLM prefill (Sheared-LLaMA-2.7B on Orin): tokens/s
    prefill_tokens_per_sec: float = 400.0
    # autoregressive decode: one forward pass per tick, memory-bandwidth
    # bound, so a continuous-batching tick advances EVERY live slot at
    # roughly the single-stream rate — batch decode time is per-token,
    # not per-(token, slot)
    decode_tokens_per_sec: float = 20.0

    def embed_latency(self, n_chars: int) -> float:
        return self.embed_fixed_s + n_chars / self.embed_chars_per_sec

    @property
    def index_memory_budget(self) -> float:
        return self.device_memory_bytes - self.model_reserved_bytes

    def storage_load_latency(self, n_bytes: int) -> float:
        """Sequential read of a contiguously-stored cluster."""
        return self.storage_seek_s + n_bytes / self.storage_seq_bw_bytes_per_sec

    def mem_load_latency(self, n_bytes: int, resident_bytes: float = 0.0) -> float:
        """DRAM access; degrades to random-read thrashing when the resident
        index exceeds its memory budget (Fig. 3's regime)."""
        if resident_bytes > self.index_memory_budget:
            over = ((resident_bytes - self.index_memory_budget)
                    / resident_bytes)
            # fraction `over` of accesses page-fault as scattered 4K reads
            return (n_bytes * (1 - over) / self.dram_bw_bytes_per_sec
                    + n_bytes * over / self.storage_rand_bw_bytes_per_sec)
        return n_bytes / self.dram_bw_bytes_per_sec

    def search_latency(self, n_vectors: int, dim: int) -> float:
        return 2.0 * n_vectors * dim / self.search_flops_per_sec

    def dequant_latency(self, n_values: int) -> float:
        """Decode cost of a quantized storage codec (zero work for fp32)."""
        return n_values / self.dequant_values_per_sec

    def fused_dequant_latency(self, n_values: int) -> float:
        """In-kernel decode of a quantized slab segment, charged once per
        slab (per unique cluster) — never per probing query."""
        return n_values / self.fused_dequant_values_per_sec

    def pq_lut_latency(self, dim: int, n_centroids: int = 256) -> float:
        """Building ONE query's ADC tables: every subspace dots the query
        slice against its 256 centroids — together one (256, dim) matmul,
        2·256·dim flops.  Charged per query per batch (the tables are
        reused across every PQ row the query scores)."""
        return 2.0 * n_centroids * dim / self.search_flops_per_sec

    def pq_gather_latency(self, n_lookups: int) -> float:
        """In-kernel gather+accumulate over PQ codes, owner-charged once
        per slab cluster (rows × m lookups) — replaces the dequant charge
        other codecs pay."""
        return n_lookups / self.pq_lookup_values_per_sec

    def slab_pack_latency(self, n_bytes: int) -> float:
        """Copying one resolved cluster's compact payload into the batch
        slab: a DRAM read + write.  Replaces the old per-query concat,
        which re-copied every shared cluster once per probing query."""
        return 2.0 * n_bytes / self.dram_bw_bytes_per_sec

    def wal_fsync_latency(self, n_bytes: int) -> float:
        """Appending + fsyncing one WAL frame (or snapshot payload): a
        flash write barrier (same order as a seek on SD-class media) plus
        the frame streamed at sequential bandwidth.  Charged per durable
        mutation when a ``Durability`` handle is attached
        (core/durability.py)."""
        return self.storage_seek_s + n_bytes / self.storage_seq_bw_bytes_per_sec

    def prefill_latency(self, n_tokens: int) -> float:
        return n_tokens / self.prefill_tokens_per_sec

    def decode_latency(self, n_tokens: int) -> float:
        """Decode ticks for ``n_tokens`` output tokens (whole batch: each
        tick advances every live slot, see ``decode_tokens_per_sec``)."""
        return n_tokens / self.decode_tokens_per_sec


@dataclasses.dataclass
class LatencyBreakdown:
    """Per-query accounting (simulated edge seconds + real wall seconds)."""
    embed_query_s: float = 0.0
    centroid_search_s: float = 0.0
    l2_generate_s: float = 0.0
    l2_storage_load_s: float = 0.0
    l2_dequant_s: float = 0.0   # codec decode — compute, not storage I/O
    l2_cache_hit_s: float = 0.0
    l2_mem_load_s: float = 0.0
    l2_search_s: float = 0.0
    # packed-slab scoring engine (owner-charged, once per unique cluster):
    l2_slab_pack_s: float = 0.0         # compact payload copy into the slab
    l2_fused_dequant_s: float = 0.0     # in-kernel fp16/int8 decode
    # PQ tier (charged INSTEAD of dequant for pq segments):
    l2_pq_lut_s: float = 0.0            # per-query ADC table build
    l2_pq_gather_s: float = 0.0         # in-kernel code gather+accumulate
    # failure model (core/faults.py) — zero on the fault-free path:
    l2_stall_s: float = 0.0             # injected storage stall tail (I/O)
    l2_retry_backoff_s: float = 0.0     # modeled retry exponential backoff
    # durability (core/durability.py) — the WAL record a retrieval-path
    # Alg. 1 self-heal re-persist emits; zero unless a handle is attached:
    wal_fsync_s: float = 0.0
    wall_s: float = 0.0
    n_clusters_probed: int = 0
    n_generated: int = 0
    n_storage_loads: int = 0
    n_cache_hits: int = 0
    n_shared_hits: int = 0      # batched search: cluster resolved by a peer
    chars_embedded: int = 0
    # degradation ladder accounting (core/faults.py):
    retries: int = 0            # storage read attempts that were retried
    degraded_clusters: int = 0  # probes shed / regens skipped under deadline
    stale_served: int = 0       # stale payloads scored instead of regenerated

    # retrieval fields grouped by the serving pipeline stage that does the
    # work (serving/pipeline.py): S1 probe/plan, S2 storage fetch / regen,
    # S3 slab pack + score.  The three partitions are exhaustive —
    # ``retrieval_s`` is exactly their sum, asserted in tests.
    STAGE_FIELDS = {
        "plan": ("embed_query_s", "centroid_search_s"),
        "fetch": ("l2_generate_s", "l2_storage_load_s", "l2_dequant_s",
                  "l2_cache_hit_s", "l2_stall_s", "l2_retry_backoff_s",
                  "wal_fsync_s"),
        "score": ("l2_slab_pack_s", "l2_fused_dequant_s", "l2_pq_lut_s",
                  "l2_pq_gather_s", "l2_mem_load_s", "l2_search_s"),
    }

    def stage_s(self, stage: str) -> float:
        """Edge seconds this query spent in one pipeline stage."""
        return sum(getattr(self, f) for f in self.STAGE_FIELDS[stage])

    @property
    def retrieval_s(self) -> float:
        return (self.stage_s("plan") + self.stage_s("fetch")
                + self.stage_s("score"))

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d.pop("STAGE_FIELDS", None)
        return d | {"retrieval_s": self.retrieval_s}


class WallTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
