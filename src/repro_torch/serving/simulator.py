"""Paper-scale edge simulator.

Port of ``repro.serving.simulator``, line for line.  It models the EDGE
device of the paper (its memory, storage and embedder rates, through
:class:`~repro_torch.core.costs.EdgeCostModel`) in numpy on the host: it
takes no ``device``, allocates no tensor and never runs on the card, so its
seconds are the modeled edge device's, not the GPU's.

The algorithms in ``repro_torch.core`` always run for real; this module
answers "what would Fig. 3 / Fig. 13 look like at the PAPER's dataset sizes
on the PAPER's hardware" by replaying the cost model at Table 2 scale
without allocating 18.5 GB of embeddings.

It simulates the five Table 4 configurations over a query trace:
cluster-size distributions (log-normal tail) and Zipf access skew are drawn
to match the synthetic generator, scaled to the full record counts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.cache_policy import (CostAwareLFUCache,
                                           MinLatencyThresholdController)
from repro_torch.core.costs import BYTES_PER_EMBEDDING_F32, EdgeCostModel
from repro_torch.data.synthetic import BEIR_SPECS


@dataclasses.dataclass
class SimResult:
    config: str
    dataset: str
    mean_retrieval_s: float
    p50_s: float
    p95_s: float
    p99_s: float
    mean_ttft_s: float
    resident_bytes: float
    cache_hit_rate: float = 0.0
    slo_hit_rate: float = 1.0


class EdgeSimulator:
    """Replays a query trace through each index configuration's cost model."""

    def __init__(self, dataset: str, *, nlist: Optional[int] = None,
                 nprobe: int = 8, n_queries: int = 500, seed: int = 0,
                 cost: Optional[EdgeCostModel] = None,
                 mean_chunk_chars: int = 300,
                 prompt_tokens: int = 1200,
                 model_bytes: float = 5.4e9,       # Sheared-LLaMA-2.7B bf16
                 model_evict_frac: float = 0.05):
        spec = BEIR_SPECS[dataset]
        self.spec = spec
        self.cost = cost or EdgeCostModel()
        self.nprobe = nprobe
        self.prompt_tokens = prompt_tokens
        self.model_bytes = model_bytes
        self.model_evict_frac = model_evict_frac
        # cluster granularity calibrated to Fig. 5: median generation cost a
        # few hundred ms => ~30 chunks (~10 kchars) per cluster
        if nlist is None:
            nlist = max(256, spec.n_records // 32)
        rng = np.random.default_rng(seed)
        # cluster sizes (records): log-normal tail, matched to Fig. 5
        raw = rng.lognormal(0.0, 1.0, nlist)
        self.cluster_records = np.maximum(
            1, raw / raw.sum() * spec.n_records).astype(np.int64)
        self.cluster_chars = self.cluster_records * mean_chunk_chars
        self.cluster_bytes = self.cluster_records * BYTES_PER_EMBEDDING_F32
        self.dim = 768
        # query trace: Zipf reuse skew (Table 2) over a random cluster
        # permutation — access frequency is topical, not size-correlated
        zipf_a = {"scidocs": 1.5, "fiqa": 2.2, "quora": 1.6, "nq": 1.25,
                  "hotpotqa": 1.35, "fever": 1.8}[dataset]
        rank = rng.permutation(nlist)
        draws = rng.zipf(zipf_a, size=(n_queries, nprobe))
        self.trace = rank[np.minimum(draws - 1, nlist - 1)]
        self.query_chars = rng.integers(40, 160, size=n_queries)

    # ------------------------------------------------------------------
    def _ttft(self, retrieval_s: float, resident_bytes: float = 0.0) -> float:
        prefill = self.cost.prefill_latency(self.prompt_tokens)
        if resident_bytes > self.cost.index_memory_budget:
            # the index working set evicted part of the generation model
            # (paper §6.3.4: "eviction of the generation model from memory")
            prefill += (self.model_evict_frac * self.model_bytes
                        / self.cost.storage_seq_bw_bytes_per_sec)
        return retrieval_s + prefill

    def run(self, config: str, *, cache_frac: float = 0.07,
            slo_s: Optional[float] = None) -> SimResult:
        """config ∈ {flat, ivf, ivf_gen, ivf_gen_load, edgerag} (Table 4)."""
        c = self.cost
        spec = self.spec
        slo_s = slo_s if slo_s is not None else spec.slo_s
        nlist = len(self.cluster_records)
        centroid_bytes = nlist * self.dim * 4
        total_emb_bytes = float(self.cluster_bytes.sum())
        lat_centroid = (c.mem_load_latency(centroid_bytes)
                        + c.search_latency(nlist, self.dim))
        lats: List[float] = []
        cache = None
        thr = None
        stored = np.zeros(nlist, bool)
        if config in ("ivf_gen_load", "edgerag"):
            gen_lat = c.embed_latency(0) + self.cluster_chars / c.embed_chars_per_sec
            stored = gen_lat > slo_s                 # Alg. 1 at index time
        if config == "edgerag":
            cache = CostAwareLFUCache(int(cache_frac * c.device_memory_bytes))
            thr = MinLatencyThresholdController()
        resident = {
            "flat": total_emb_bytes,
            "ivf": centroid_bytes + total_emb_bytes,
            "ivf_gen": centroid_bytes,
            "ivf_gen_load": centroid_bytes,
            "edgerag": centroid_bytes,               # + cache, counted below
        }[config]

        # OS page cache over cluster pages for over-memory in-memory configs:
        # hot (Zipf head) clusters stay resident; cold accesses page in as
        # scattered reads.  Budget = what's left after model + centroids.
        from collections import OrderedDict
        page_cache: "OrderedDict[int, float]" = OrderedDict()
        page_budget = max(0.0, c.index_memory_budget - centroid_bytes)
        page_used = 0.0

        def paged_load(cl: int, nb: float) -> float:
            nonlocal page_used
            if resident <= c.index_memory_budget:
                return c.mem_load_latency(nb)
            if cl in page_cache:
                page_cache.move_to_end(cl)
                return nb / c.dram_bw_bytes_per_sec
            while page_used + nb > page_budget and page_cache:
                _, old_nb = page_cache.popitem(last=False)
                page_used -= old_nb
            if nb <= page_budget:
                page_cache[cl] = nb
                page_used += nb
            return c.storage_seek_s + nb / c.storage_rand_bw_bytes_per_sec

        for qi, probed in enumerate(self.trace):
            q_embed = c.embed_latency(int(self.query_chars[qi]))
            if config == "flat":
                lat = q_embed + c.mem_load_latency(
                    total_emb_bytes, resident_bytes=resident) \
                    + c.search_latency(int(spec.n_records), self.dim)
                lats.append(self._ttft(lat, resident))
                continue
            lat = q_embed + lat_centroid
            scanned = 0
            missed = False
            for cl in probed:
                nb = float(self.cluster_bytes[cl])
                scanned += int(self.cluster_records[cl])
                if config == "ivf":
                    lat += paged_load(int(cl), nb)
                    continue
                if stored[cl]:
                    lat += c.storage_load_latency(nb)
                    continue
                gen_s = c.embed_latency(int(self.cluster_chars[cl]))
                if cache is not None:
                    hit = cache.access(int(cl)) is not None
                    if hit:
                        lat += c.mem_load_latency(nb)
                        continue
                    missed = True
                    lat += gen_s
                    # cache stores a byte-sized dummy (policy is what matters)
                    cache.insert(int(cl), np.empty(int(nb), np.uint8),
                                 gen_s, thr.threshold)
                else:
                    lat += gen_s
            lat += c.search_latency(scanned, self.dim)
            if thr is not None:
                new_thr = thr.observe(missed, lat)
                if missed:
                    cache.drop_below_threshold(new_thr)
            lats.append(self._ttft(lat, resident))

        lats_np = np.asarray(lats)
        retr = lats_np - c.prefill_latency(self.prompt_tokens)
        retr = np.maximum(retr, 0.0)
        if config == "edgerag" and cache is not None:
            resident += cache.total_bytes()
        return SimResult(
            config=config, dataset=spec.name,
            mean_retrieval_s=float(retr.mean()),
            p50_s=float(np.percentile(retr, 50)),
            p95_s=float(np.percentile(retr, 95)),
            p99_s=float(np.percentile(retr, 99)),
            mean_ttft_s=float(lats_np.mean()),
            resident_bytes=float(resident),
            cache_hit_rate=cache.hit_rate if cache else 0.0,
            slo_hit_rate=float((retr <= slo_s).mean()))


@dataclasses.dataclass
class TenantTrace:
    """A multi-tenant request arrival trace: who asks, and when.

    ``tenant_ids[i]`` is the tenant issuing request ``i`` at
    ``arrival_s[i]``.  Produced by :func:`zipf_over_tenants`; consumed by
    the multi-tenant benchmark and any :class:`RequestScheduler` setup.
    """
    arrival_s: np.ndarray        # (N,) f64, nondecreasing
    tenant_ids: np.ndarray       # (N,) int64, rank 0 = hottest tenant
    n_tenants: int
    zipf_a: float

    def __len__(self) -> int:
        return len(self.arrival_s)

    def counts(self) -> Dict[int, int]:
        """Requests per tenant rank (ranks with zero draws included)."""
        out = {t: 0 for t in range(self.n_tenants)}
        for t in self.tenant_ids:
            out[int(t)] += 1
        return out


def zipf_over_tenants(n_tenants: int, n_requests: int, *,
                      zipf_a: float = 1.2, gap_mean_s: float = 0.05,
                      seed: int = 0) -> TenantTrace:
    """Zipf-skewed tenant mix with Poisson arrivals.

    Real multi-tenant request streams are head-heavy: one or two tenants
    dominate while the tail trickles.  Tenant rank for each request is a
    TRUNCATED Zipf(``zipf_a``) draw over exactly ``n_tenants`` ranks
    (rank 0 hottest; probabilities ∝ 1/(rank+1)^a — clipping an unbounded
    Zipf would dump the whole tail's mass onto the last rank instead);
    inter-arrival gaps are exponential with mean ``gap_mean_s``, so the
    trace is a Poisson process over a Zipf tenant marginal.
    """
    assert n_tenants >= 1 and n_requests >= 1
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, n_tenants + 1, dtype=np.float64) ** zipf_a
    tenant_ids = rng.choice(n_tenants, size=n_requests,
                            p=weights / weights.sum()).astype(np.int64)
    arrival_s = np.cumsum(rng.exponential(gap_mean_s, size=n_requests))
    return TenantTrace(arrival_s=arrival_s, tenant_ids=tenant_ids,
                       n_tenants=n_tenants, zipf_a=zipf_a)


def simulate_ttft(datasets: Optional[List[str]] = None,
                  configs: Optional[List[str]] = None,
                  **kw) -> Dict[str, Dict[str, SimResult]]:
    """Fig. 13 analogue: TTFT for all five Table 4 configs × datasets."""
    datasets = datasets or list(BEIR_SPECS)
    configs = configs or ["flat", "ivf", "ivf_gen", "ivf_gen_load", "edgerag"]
    out: Dict[str, Dict[str, SimResult]] = {}
    for ds in datasets:
        sim = EdgeSimulator(ds, **kw)
        out[ds] = {cfg: sim.run(cfg) for cfg in configs}
    return out
