"""EdgeRAG's caching policy — faithful implementations of the paper's
Algorithm 2 (Cost-aware Least-Frequently-Used replacement) and Algorithm 3
(adaptive Minimum Latency Caching Threshold).

Algorithm 2 as printed contains an obvious typo (``minCost``/``maxCost``
mixed up inside the eviction scan); we implement the stated intent: evict
the cached cluster with the MINIMUM ``genLatency × counter`` weight — cheap
to regenerate and rarely used goes first.  After every access all counters
decay by ``decay_factor`` so stale frequency evidence ages out.

Algorithm 3: the threshold starts at 0 (cache everything).  On a cache miss
whose overall retrieval latency beat the moving average, the threshold is
RAISED (the miss was affordable — stop caching cheap clusters); on a cache
hit it is LOWERED (hits are valuable — admit more).  Clusters whose
generation latency falls below the threshold are neither admitted nor kept.

MULTI-TENANCY: keys may be ints (single-tenant, unchanged) or
``(tenant, cid)`` tuples on a SHARED cache.  Eviction stays one global
argmin over ``gen_latency x counter`` — tenants compete for the one byte
budget exactly as the paper's single-tenant policy competes across
clusters — while ``per_tenant`` tracks each tenant's bytes / entries /
hits / misses / evictions so fairness is observable.
:class:`TenantCacheView` gives one tenant an int-keyed facade (its Alg. 3
``drop_below_threshold`` is scoped to its own entries; other tenants'
thresholds are none of its business).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

_ANY_TENANT = object()      # sentinel: drop_below_threshold over all tenants


def tenant_of(key) -> Optional[str]:
    """Tenant component of a cache/storage key (``None`` for bare ints)."""
    return key[0] if isinstance(key, tuple) else None


@dataclasses.dataclass
class CacheEntry:
    embeddings: np.ndarray
    gen_latency: float
    counter: float = 1.0

    @property
    def nbytes(self) -> int:
        return self.embeddings.nbytes


class CostAwareLFUCache:
    """Algorithm 2. Capacity in bytes (the paper reports ~7% of system mem).

    PERF NOTE — lazy decay + running byte total: the paper's "after every
    access all counters decay by ``decay_factor``" is implemented WITHOUT
    walking every entry per access.  Entries store counters in a scaled
    basis: the effective counter is ``entry.counter * _decay_mult``, and a
    global decay is one multiply of ``_decay_mult`` (a counter bump adds
    ``1 / _decay_mult`` in the scaled basis).  Eviction order is unchanged —
    argmin of ``gen_latency * counter`` is invariant under the common
    positive factor — and ``_decay_mult`` is folded back into the entries
    whenever it underflows toward the f64 floor, so the basis never loses
    precision.  ``total_bytes`` is likewise a maintained running total
    instead of a full scan on every insert.  Hit/miss/eviction semantics
    are identical to the eager implementation (covered by the existing
    tests plus the equivalence test in tests/test_slab_scoring.py).
    """

    _RENORM_BELOW = 1e-150      # fold the global multiplier back into
    #                             entries long before f64 underflow

    def __init__(self, capacity_bytes: int, decay_factor: float = 0.99):
        self.capacity_bytes = capacity_bytes
        self.decay_factor = decay_factor
        self._entries: Dict[object, CacheEntry] = {}
        self._decay_mult = 1.0          # global lazy-decay multiplier
        self._total_bytes = 0           # running byte total
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # per-tenant accounting (module docstring); the None tenant is the
        # bare-int single-tenant key space
        self.per_tenant: Dict[Optional[str], Dict[str, int]] = {}

    def _tstats(self, tenant: Optional[str]) -> Dict[str, int]:
        st = self.per_tenant.get(tenant)
        if st is None:
            st = self.per_tenant[tenant] = {
                "bytes": 0, "entries": 0, "hits": 0, "misses": 0,
                "evictions": 0}
        return st

    def fresh(self) -> "CostAwareLFUCache":
        """A brand-new empty cache with this one's configuration (index
        rebuilds swap to it; the shared-view override clears in place)."""
        return CostAwareLFUCache(self.capacity_bytes, self.decay_factor)

    # ---- Alg. 2 ----
    def access(self, cluster_id) -> Optional[np.ndarray]:
        """Lookup; bumps the counter on hit, decays all counters (O(1))."""
        entry = self._entries.get(cluster_id)
        st = self._tstats(tenant_of(cluster_id))
        if entry is not None:
            entry.counter += 1.0 / self._decay_mult     # effective += 1
            self.hits += 1
            st["hits"] += 1
            out = entry.embeddings
        else:
            self.misses += 1
            st["misses"] += 1
            out = None
        self._decay()
        return out

    def insert(self, cluster_id, embeddings: np.ndarray,
               gen_latency: float, min_latency_threshold: float = 0.0):
        """Insert after a miss+regeneration, honoring the Alg. 3 threshold."""
        if gen_latency < min_latency_threshold:
            return  # not worth caching — cheap to regenerate (Alg. 3)
        nbytes = embeddings.nbytes
        if nbytes > self.capacity_bytes:
            return
        # NOTE: when re-inserting a key that is still cached, the eviction
        # loop runs with the old entry's bytes still counted (and the old
        # entry itself is a legal victim) — exactly the eager original
        while self._total_bytes + nbytes > self.capacity_bytes:
            if not self._evict_one():
                return
        old = self._entries.get(cluster_id)
        st = self._tstats(tenant_of(cluster_id))
        if old is not None:             # replaced, not evicted
            self._total_bytes -= old.nbytes
            st["bytes"] -= old.nbytes
            st["entries"] -= 1
        entry = CacheEntry(
            embeddings=np.ascontiguousarray(embeddings, np.float32),
            gen_latency=float(gen_latency),
            counter=1.0 / self._decay_mult)             # effective 1.0
        self._entries[cluster_id] = entry
        # the running total tracks the STORED (f32) entry, like the eager
        # scan did — the admit/evict decisions above use the caller's
        # nbytes, also like the eager code
        self._total_bytes += entry.nbytes
        st["bytes"] += entry.nbytes
        st["entries"] += 1

    def _drop_entry(self, cluster_id, *, evicted: bool):
        entry = self._entries.pop(cluster_id)
        self._total_bytes -= entry.nbytes
        st = self._tstats(tenant_of(cluster_id))
        st["bytes"] -= entry.nbytes
        st["entries"] -= 1
        if evicted:
            self.evictions += 1
            st["evictions"] += 1

    def _evict_one(self) -> bool:
        if not self._entries:
            return False
        evict_id = min(self._entries,
                       key=lambda i: (self._entries[i].gen_latency
                                      * self._entries[i].counter))
        self._drop_entry(evict_id, evicted=True)
        return True

    def _decay(self):
        self._decay_mult *= self.decay_factor
        if self._decay_mult < self._RENORM_BELOW:
            for e in self._entries.values():            # rare: amortized O(1)
                e.counter *= self._decay_mult
            self._decay_mult = 1.0

    # ---- maintenance used by Alg. 3's "evicts and prevents caching" ----
    def drop_below_threshold(self, threshold: float, tenant=_ANY_TENANT):
        """Evict entries whose gen latency is under ``threshold``; pass
        ``tenant=`` to scope the sweep to one tenant's entries (each
        tenant's Alg. 3 controller governs only its own clusters)."""
        for cid in [c for c, e in self._entries.items()
                    if e.gen_latency < threshold
                    and (tenant is _ANY_TENANT or tenant_of(c) == tenant)]:
            self._drop_entry(cid, evicted=True)

    def invalidate(self, cluster_id):
        if cluster_id in self._entries:
            self._drop_entry(cluster_id, evicted=False)

    def invalidate_tenant(self, tenant: Optional[str]) -> int:
        """Drop every entry belonging to ``tenant``; returns bytes freed."""
        freed = 0
        for cid in [c for c in self._entries if tenant_of(c) == tenant]:
            freed += self._entries[cid].nbytes
            self._drop_entry(cid, evicted=False)
        return freed

    def total_bytes(self) -> int:
        return self._total_bytes

    def tenant_bytes(self, tenant: Optional[str]) -> int:
        st = self.per_tenant.get(tenant)
        return st["bytes"] if st else 0

    def tenant_entries(self, tenant: Optional[str]) -> int:
        st = self.per_tenant.get(tenant)
        return st["entries"] if st else 0

    def __contains__(self, cluster_id) -> bool:
        return cluster_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class TenantCacheView:
    """One tenant's int-keyed facade over a SHARED :class:`CostAwareLFUCache`.

    Key mapping mirrors :class:`~repro_torch.core.storage.TenantStorageView`:
    ``cid -> (tenant, cid)``.  ``total_bytes`` is the SHARED resident
    total — on one device the cache occupies one budget, and the cost
    model's resident-set pressure must see all tenants (this also keeps a
    one-tenant router's ``memory_bytes`` identical to a standalone
    index).  ``tenant_bytes`` / ``hits`` / ``misses`` / ``hit_rate`` /
    ``__len__`` are scoped to this tenant, as is ``drop_below_threshold``
    (per-tenant Alg. 3).  ``fresh`` clears only this tenant's entries."""

    def __init__(self, shared: CostAwareLFUCache, tenant: str):
        self.shared = shared
        self.tenant = str(tenant)

    def _k(self, cid: int) -> Tuple[str, int]:
        return (self.tenant, int(cid))

    @property
    def capacity_bytes(self) -> int:
        return self.shared.capacity_bytes

    @property
    def decay_factor(self) -> float:
        return self.shared.decay_factor

    def fresh(self) -> "TenantCacheView":
        self.shared.invalidate_tenant(self.tenant)
        return self

    def access(self, cid: int) -> Optional[np.ndarray]:
        return self.shared.access(self._k(cid))

    def insert(self, cid: int, embeddings: np.ndarray, gen_latency: float,
               min_latency_threshold: float = 0.0):
        self.shared.insert(self._k(cid), embeddings, gen_latency,
                           min_latency_threshold)

    def invalidate(self, cid: int):
        self.shared.invalidate(self._k(cid))

    def drop_below_threshold(self, threshold: float):
        self.shared.drop_below_threshold(threshold, tenant=self.tenant)

    def total_bytes(self) -> int:
        return self.shared.total_bytes()

    def tenant_bytes(self) -> int:
        return self.shared.tenant_bytes(self.tenant)

    def __contains__(self, cid: int) -> bool:
        return self._k(cid) in self.shared

    def __len__(self) -> int:
        return self.shared.tenant_entries(self.tenant)

    @property
    def hits(self) -> int:
        st = self.shared.per_tenant.get(self.tenant)
        return st["hits"] if st else 0

    @property
    def misses(self) -> int:
        st = self.shared.per_tenant.get(self.tenant)
        return st["misses"] if st else 0

    @property
    def evictions(self) -> int:
        st = self.shared.per_tenant.get(self.tenant)
        return st["evictions"] if st else 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class MinLatencyThresholdController:
    """Algorithm 3.  ``step_s`` is the +-/-- increment in seconds."""

    def __init__(self, step_s: float = 0.010, ema_alpha: float = 0.1):
        self.threshold = 0.0
        self.step_s = step_s
        self.alpha = ema_alpha
        self.moving_avg_latency = 0.0
        self._initialized = False

    def observe(self, cache_miss: bool, last_latency: float) -> float:
        if not self._initialized:
            self.moving_avg_latency = last_latency
            self._initialized = True
        if cache_miss:
            if last_latency < self.moving_avg_latency:
                self.threshold += self.step_s
        else:
            self.threshold = max(0.0, self.threshold - self.step_s)
        self.moving_avg_latency = ((1 - self.alpha) * self.moving_avg_latency
                                   + self.alpha * last_latency)
        return self.threshold
