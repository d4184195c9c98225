"""Multi-tenant index service: shared substrate behind a TenantRouter.

Port of ``repro.core.tenant``.  The router holds one storage backend, one
cache and one maintenance multiplexer for every tenant, on one ``device``
(the card unless ``device="cpu"``); each tenant's
:class:`~repro_torch.core.edgerag.EdgeRAGIndex` probes its own centroids
with ``ivf_topk`` on that device, and a mixed batch scores every tenant's
resolved clusters in ONE ``slab_topk`` launch per storage representation.
``enable_durability`` gives every tenant its own WAL and snapshots under
the shared root (``recover_router`` restores them all); the sharded
``mesh=`` route comes with a later slice and raises
:class:`NotImplementedError` here.

EdgeRAG's premise is many indexes sharing one memory-constrained device
(arXiv 2412.21023), and on a single device the win comes from multiplexing
every tenant's retrieval through ONE shared engine rather than siloed
per-index stacks (RAGDoll, arXiv 2504.15302):

  storage      one :class:`~repro_torch.core.storage.StorageBackend`
               holding every tenant's blobs under ``(tenant, cid)`` keys
               and one optional shared byte budget; each tenant's index
               sees an int-keyed
               :class:`~repro_torch.core.storage.TenantStorageView`
  cache        one :class:`~repro_torch.core.cache_policy.CostAwareLFUCache`
               (one DRAM budget, global cost-aware eviction, per-tenant
               accounting) behind per-tenant
               :class:`~repro_torch.core.cache_policy.TenantCacheView`\\ s
  maintenance  per-tenant :class:`~repro_torch.core.maintenance
               .MaintenanceScheduler`\\ s multiplexed by
               :class:`~repro_torch.core.maintenance.FairShareMaintenance`
               — effective queue keys are ``(tenant, kind, cid)`` and idle
               windows drain round-robin across tenants
  scoring      one slab engine: a mixed-tenant batch resolves per tenant
               (S1 probe / S2 fetch are tenant-local by construction — the
               centroid tables are disjoint) but packs ALL tenants'
               resolved clusters into a single
               :class:`~repro_torch.core.resolver.SlabLayout` and scores
               every query in ONE ragged ``slab_topk`` launch per storage
               representation.  Cluster identity is ``(tenant, cid)`` end
               to end through the merged :class:`ResolutionPlan`.

BIT-IDENTICALITY.  Fusing tenants into one slab cannot perturb any query's
results: the virt matrix masks every row outside the query's own probe
list, so per-(query, cluster) scores are independent of what else shares
the launch, and the kernel's scores are batch-invariant.  Inside the port a
mixed batch therefore equals each tenant's queries served by its own index,
bitwise.  A router with ONE tenant replays a standalone
:class:`EdgeRAGIndex` exactly — same kernel calls, same cache/threshold
mutations, same modeled charges.

Serving integration: :class:`~repro_torch.serving.engine.RAGEngine`,
:class:`~repro_torch.serving.pipeline.StagedPipeline`, and
:class:`~repro_torch.serving.scheduler.RequestScheduler` accept a router as
their ``index`` and thread a per-query ``tenants`` list through the stage
methods; per-tenant SLO-aware admission lives in
:class:`~repro_torch.serving.scheduler.TokenBucketAdmission`.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cache_policy import CostAwareLFUCache, TenantCacheView
from repro_torch.core.costs import EdgeCostModel, LatencyBreakdown, WallTimer
from repro_torch.core.durability import Durability
from repro_torch.core.edgerag import (BatchSearchState, EdgeRAGIndex,
                                      slab_score_topk)
from repro_torch.core.faults import DegradationPolicy
from repro_torch.core.maintenance import FairShareMaintenance
from repro_torch.core.resolver import (ClusterResolver, ResolutionPlan,
                                       SlabPayload)
from repro_torch.core.storage import StorageBackend, TenantStorageView
from repro_torch.device import DeviceLike, resolve_device

_TENANT_ID_RE = re.compile(r"^[A-Za-z0-9._-]+$")

TenantKey = Tuple[str, int]     # cluster identity across the router


class _TenantClusters:
    """``(tenant, cid) -> EdgeCluster`` mapping facade.

    The shared :class:`~repro_torch.core.resolver.ClusterResolver` methods
    the router reuses (``pack_slab``, ``stale_cids``) only ever index
    ``index.clusters[key]`` — this facade routes the composite key to the
    owning tenant's cluster table, so those methods work verbatim over a
    merged cross-tenant plan."""

    def __init__(self, router: "TenantRouter"):
        self._router = router

    def __getitem__(self, key: TenantKey):
        tenant, cid = key
        return self._router.tenants[tenant].clusters[cid]


@dataclasses.dataclass
class MultiTenantSearchState:
    """In-flight state of one mixed-tenant staged retrieval.

    Mirrors :class:`~repro_torch.core.edgerag.BatchSearchState` where the
    serving layer is concerned (``plan`` / ``lats`` / ``missed`` /
    ``payloads`` / ``nq`` / ``shrink_deadlines`` / ``centroid_total_s``)
    but holds one per-tenant :class:`BatchSearchState` per tenant present
    in the batch plus the MERGED ``(tenant, cid)``-keyed plan the fused S3
    scores from.  ``lats[qi]`` is the SAME LatencyBreakdown object as the
    owning tenant state's local entry, so per-tenant stage charges land in
    the global view without copying."""
    queries: np.ndarray                      # (Q, d) f32, global batch order
    k: int
    plan: ResolutionPlan                     # merged, (tenant, cid) keys
    lats: List[LatencyBreakdown]             # global order, shared objects
    missed: List[bool]
    tenants: List[str]                       # per-query tenant id
    order: Dict[str, List[int]]              # tenant -> global qi list
    states: Dict[str, BatchSearchState]      # per-tenant staged states
    payloads: Optional[Dict[TenantKey, SlabPayload]] = None
    wall_accum_s: float = 0.0                # router-side (merge) wall time

    @property
    def nq(self) -> int:
        return self.queries.shape[0]

    @property
    def centroid_total_s(self) -> float:
        """S1 runs ONE centroid launch PER TENANT in the batch — the
        stage's edge occupancy is their sum, not one tenant's charge."""
        return sum(st.centroid_total_s for st in self.states.values())

    def shrink_deadlines(self, extra_wait_s: float):
        for st in self.states.values():
            st.shrink_deadlines(extra_wait_s)


class TenantRouter:
    """Routes per-tenant corpora onto one shared EdgeRAG substrate.

    ``create_tenant`` builds an :class:`EdgeRAGIndex` whose storage and
    cache are views into the router's shared backend / cache and whose
    maintenance scheduler joins the fair-share drain.  Mixed batches go
    through :meth:`search_batch` (or the staged ``search_begin`` /
    ``search_fetch`` / ``search_finish`` the serving pipeline calls) with
    a per-query ``tenants`` list; per-tenant probing and resolution feed
    ONE fused cross-tenant slab launch per storage representation.
    ``device`` is where every tenant's index, the shared backend's PQ
    training and the fused scoring run (the card unless ``"cpu"``).
    """

    def __init__(self, dim: int, cost_model: Optional[EdgeCostModel] = None,
                 *, slo_s: float = 1.0,
                 cache_bytes: Optional[int] = None,
                 storage_mode: str = "memory",
                 storage_codec: str = "fp32",
                 storage_root: Optional[str] = None,
                 storage_budget_bytes: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dim = dim
        self.cost = cost_model or EdgeCostModel()
        self.slo_s = slo_s
        if cache_bytes is None:
            cache_bytes = int(0.07 * self.cost.device_memory_bytes)  # §6.3.4
        self.cache = CostAwareLFUCache(cache_bytes)
        self.storage = StorageBackend(storage_mode, root=storage_root,
                                      codec=storage_codec,
                                      budget_bytes=storage_budget_bytes,
                                      device=self.device)
        self.maintenance = FairShareMaintenance()
        self.tenants: Dict[str, EdgeRAGIndex] = {}
        self.clusters = _TenantClusters(self)
        # pack_slab / stale_cids run against the router as if it were an
        # index: they only touch .dim / .cost / .clusters[key]
        self.resolver = ClusterResolver(self)
        self._durability_cfg: Optional[Dict] = None

    # ------------------------------------------------------------------
    # tenant lifecycle
    # ------------------------------------------------------------------
    def create_tenant(self, tenant_id: str,
                      embed_fn: Callable[[Sequence[str]], np.ndarray],
                      get_chunks: Callable[[Sequence[int]], List[str]],
                      *, slo_s: Optional[float] = None,
                      store_heavy: bool = True,
                      split_max_chars: int = 200_000,
                      merge_min_size: int = 2,
                      maintenance: str = "deferred",
                      maintenance_budget_s: Optional[float] = None
                      ) -> EdgeRAGIndex:
        """Register a tenant and return its index (call ``build`` on it).
        The index owns its first level (centroids, cluster table, Alg. 3
        threshold) and SHARES the router's storage / cache / maintenance
        substrate through tenant-scoped views."""
        tenant_id = str(tenant_id)
        assert _TENANT_ID_RE.match(tenant_id), \
            f"tenant id must match [A-Za-z0-9._-]+, got {tenant_id!r}"
        assert tenant_id not in self.tenants, \
            f"tenant {tenant_id!r} already exists"
        ix = EdgeRAGIndex(
            self.dim, embed_fn, get_chunks, self.cost,
            slo_s=self.slo_s if slo_s is None else slo_s,
            store_heavy=store_heavy,
            split_max_chars=split_max_chars,
            merge_min_size=merge_min_size,
            maintenance=maintenance,
            maintenance_budget_s=maintenance_budget_s,
            device=self.device,
            storage=TenantStorageView(self.storage, tenant_id),
            cache=TenantCacheView(self.cache, tenant_id))
        self.maintenance.register(tenant_id, ix.maintenance)
        self.tenants[tenant_id] = ix
        if self._durability_cfg is not None:
            self._attach_tenant_durability(tenant_id, checkpoint=False)
        return ix

    # ------------------------------------------------------------------
    # durability (core/durability.py)
    # ------------------------------------------------------------------
    def enable_durability(self, root: Optional[str] = None, *,
                          checkpoint_every: int = 64,
                          keep_snapshots: int = 2, checkpoint: bool = True):
        """Make every tenant's index state crash-consistent: one
        per-tenant WAL + snapshot directory
        (``<root>/durability/tenant_<t>/``) under the SHARED storage root,
        so one ``recover_router`` call restores the whole deployment.
        Applies to existing tenants now and attaches to tenants created
        later.  ``root`` defaults to the shared backend's disk root
        (required for memory-mode storage).  Returns the per-tenant
        :class:`~repro_torch.core.durability.Durability` handles."""
        root = root or self.storage.root
        if root is None:
            raise ValueError("durability needs a filesystem root: "
                             "disk-backed storage or root=")
        self._durability_cfg = {"root": root,
                                "checkpoint_every": checkpoint_every,
                                "keep_snapshots": keep_snapshots}
        return {t: self._attach_tenant_durability(
                    t, checkpoint=checkpoint
                    and self.tenants[t].centroids is not None)
                for t in self.tenants}

    def _attach_tenant_durability(self, tenant_id: str, *,
                                  checkpoint: bool):
        cfg = self._durability_cfg
        dur = Durability(cfg["root"], tenant=tenant_id,
                         cost_model=self.cost,
                         checkpoint_every=cfg["checkpoint_every"],
                         keep_snapshots=cfg["keep_snapshots"])
        # an unbuilt tenant checkpoints at build() time instead
        self.tenants[tenant_id].attach_durability(dur,
                                                  checkpoint=checkpoint)
        return dur

    def tenant(self, tenant_id: str) -> EdgeRAGIndex:
        return self.tenants[tenant_id]

    def get_chunks(self, tenant_id: str, ids: Sequence[int]) -> List[str]:
        """Per-tenant chunk-text dispatch (the serving layer's S3 context
        assembly for mixed batches)."""
        return self.tenants[tenant_id].get_chunks(ids)

    # ------------------------------------------------------------------
    # memory accounting
    # ------------------------------------------------------------------
    def memory_bytes(self) -> int:
        """Device-resident bytes: every tenant's first-level centroids plus
        the ONE shared cache (counted once — it is one resident set)."""
        n = sum(ix.centroids.nbytes for ix in self.tenants.values()
                if ix.centroids is not None)
        return n + self.cache.total_bytes()

    # ------------------------------------------------------------------
    # retrieval: per-tenant probe/resolve, fused cross-tenant scoring
    # ------------------------------------------------------------------
    def _normalize_tenants(self, tenants, nq: int) -> List[str]:
        if isinstance(tenants, str):
            tenants = [tenants] * nq
        tenants = [str(t) for t in tenants]
        assert len(tenants) == nq, \
            f"{len(tenants)} tenant ids for {nq} queries"
        for t in tenants:
            assert t in self.tenants, f"unknown tenant {t!r}"
        return tenants

    def search_begin(self, query_embs: np.ndarray, k: int, nprobe: int,
                     query_chars: Optional[Sequence[int]] = None,
                     *, tenants,
                     deadlines: Optional[Sequence[Optional[float]]] = None,
                     policy: Optional[DegradationPolicy] = None,
                     prefetch: bool = False,
                     mesh=None, shard_axis: str = "data"
                     ) -> MultiTenantSearchState:
        """S1 for a mixed batch: group queries by tenant (order within a
        tenant preserved), run each tenant's probe + plan (+ optional
        storage prefetch), and merge the per-tenant plans into ONE
        ``(tenant, cid)``-keyed :class:`ResolutionPlan` whose owner order
        follows the GLOBAL batch order — so a one-tenant batch packs the
        slab in exactly the standalone order.  ``mesh``: the sharded route
        comes with the multi-device slice and raises until then."""
        if mesh is not None:
            raise NotImplementedError(
                "the sharded mesh= route comes with the multi-device slice "
                "of the port")
        queries = np.atleast_2d(np.asarray(query_embs, np.float32))
        nq = queries.shape[0]
        tenants = self._normalize_tenants(tenants, nq)
        order: Dict[str, List[int]] = {}
        for qi, t in enumerate(tenants):
            order.setdefault(t, []).append(qi)
        states: Dict[str, BatchSearchState] = {}
        for t, gqis in order.items():
            tix = self.tenants[t]
            sub = np.ascontiguousarray(queries[gqis])
            sub_chars = (None if query_chars is None
                         else [query_chars[i] for i in gqis])
            sub_dl = (None if deadlines is None
                      else [deadlines[i] for i in gqis])
            if prefetch:
                tplan = tix.plan_batch(sub, nprobe, prefetch_storage=True,
                                       deadlines=sub_dl, policy=policy,
                                       query_chars=sub_chars)
                states[t] = tix.search_begin(sub, k, nprobe, sub_chars,
                                             plan=tplan)
            else:
                states[t] = tix.search_begin(sub, k, nprobe, sub_chars,
                                             deadlines=sub_dl, policy=policy)
        with WallTimer() as timer:
            probed_per_q: List[List[TenantKey]] = [[] for _ in range(nq)]
            lats: List[Optional[LatencyBreakdown]] = [None] * nq
            for t, gqis in order.items():
                st = states[t]
                for lqi, gqi in enumerate(gqis):
                    probed_per_q[gqi] = [(t, cid) for cid
                                         in st.plan.probed_per_q[lqi]]
                    lats[gqi] = st.lats[lqi]
            # owner insertion order = global batch order, each query's
            # probes in probe order — the standalone owner order when one
            # tenant fills the batch
            owner: Dict[TenantKey, int] = {}
            for qi in range(nq):
                for key in probed_per_q[qi]:
                    owner.setdefault(key, qi)
            tier: Dict[TenantKey, str] = {}
            generations: Dict[TenantKey, int] = {}
            content_generations: Dict[TenantKey, int] = {}
            for t, st in states.items():
                for cid in st.plan.owner:
                    key = (t, cid)
                    tier[key] = st.plan.tier[cid]
                    generations[key] = st.plan.generations[cid]
                    content_generations[key] = \
                        st.plan.content_generations[cid]
            plan = ResolutionPlan(
                probed_per_q=probed_per_q, owner=owner, tier=tier,
                storage_clusters=[], cached={}, regen_groups=[],
                generations=generations,
                content_generations=content_generations)
        return MultiTenantSearchState(
            queries=queries, k=k, plan=plan, lats=lats,
            missed=[False] * nq, tenants=tenants, order=order,
            states=states, wall_accum_s=timer.elapsed)

    def search_fetch(self, state: MultiTenantSearchState
                     ) -> MultiTenantSearchState:
        """S2: each tenant resolves its own sub-plan (tenant-scoped
        storage / cache / coalesced regeneration — embed calls never mix
        tenants' texts); payloads merge under ``(tenant, cid)`` keys."""
        payloads: Dict[TenantKey, SlabPayload] = {}
        for t, st in state.states.items():
            self.tenants[t].search_fetch(st)
            for lqi, gqi in enumerate(state.order[t]):
                if st.missed[lqi]:
                    state.missed[gqi] = True
            for cid, p in st.payloads.items():
                payloads[(t, cid)] = p
        state.payloads = payloads
        return state

    def search_finish(self, state: MultiTenantSearchState
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 List[LatencyBreakdown]]:
        """S3: pack EVERY tenant's resolved clusters into one slab and
        score all queries in ONE ragged top-k launch per storage
        representation (T tenants cost T probe launches but one scoring
        launch).  Then each tenant's Alg. 3 threshold observes its own
        queries, scoped to its own cache entries."""
        assert state.payloads is not None, "search_fetch has not run"
        lats = state.lats
        nq = state.nq
        with WallTimer() as t:
            slab = self.resolver.pack_slab(state.plan, state.payloads, lats)
            owner = state.plan.owner
            resident = self.memory_bytes()
            for qi, probed in enumerate(state.plan.probed_per_q):
                for key in probed:
                    if owner[key] != qi:
                        lats[qi].l2_mem_load_s += self.cost.mem_load_latency(
                            slab.nbytes(key), resident_bytes=resident)
                        lats[qi].n_shared_hits += 1
            out_ids, out_vals, n_valid = slab_score_topk(
                slab, state.queries, state.k, state.plan.probed_per_q,
                device=self.device)
            # same LUT-build charge as EdgeRAGIndex.search_finish: a pq
            # segment means every query's ADC tables were built this batch
            has_pq = any(seg.kind == "pq" and seg.rows
                         for seg in slab.segments)
            for qi in range(nq):
                if has_pq:
                    lats[qi].l2_pq_lut_s += self.cost.pq_lut_latency(self.dim)
                if n_valid[qi]:
                    lats[qi].l2_search_s = self.cost.search_latency(
                        int(n_valid[qi]), self.dim)
        total_wall = (state.wall_accum_s + t.elapsed
                      + sum(st.wall_accum_s for st in state.states.values()))
        state.wall_accum_s = total_wall
        for lat in lats:
            lat.wall_s = total_wall / nq
        # Alg. 3: per query in global batch order, each against ITS
        # tenant's controller and cache scope (one tenant's affordable
        # misses must not evict another tenant's entries)
        for qi in range(nq):
            if not state.plan.probed_per_q[qi]:
                continue
            tix = self.tenants[state.tenants[qi]]
            new_thr = tix.threshold.observe(state.missed[qi],
                                            lats[qi].retrieval_s)
            if state.missed[qi]:
                tix.cache.drop_below_threshold(new_thr)
        return out_ids, out_vals, lats

    def search_batch(self, query_embs: np.ndarray, k: int, nprobe: int,
                     query_chars: Optional[Sequence[int]] = None,
                     *, tenants,
                     deadlines: Optional[Sequence[Optional[float]]] = None,
                     policy: Optional[DegradationPolicy] = None,
                     mesh=None, shard_axis: str = "data"
                     ) -> Tuple[np.ndarray, np.ndarray,
                                List[LatencyBreakdown]]:
        """Mixed-tenant batched retrieval: the three staged calls
        back-to-back.  ``tenants`` is one tenant id per query (or a single
        id for the whole batch).  Per-query (ids, scores) are bitwise those
        of routing each tenant's queries through its index separately."""
        state = self.search_begin(query_embs, k, nprobe, query_chars,
                                  tenants=tenants, deadlines=deadlines,
                                  policy=policy, mesh=mesh,
                                  shard_axis=shard_axis)
        self.search_fetch(state)
        return self.search_finish(state)

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "n_tenants": len(self.tenants),
            "tenants": {t: ix.stats() for t, ix in self.tenants.items()},
            "cache": {
                "capacity_bytes": self.cache.capacity_bytes,
                "total_bytes": self.cache.total_bytes(),
                "hit_rate": self.cache.hit_rate,
                "per_tenant": {t: dict(st) for t, st
                               in self.cache.per_tenant.items()},
            },
            "storage": {
                "total_bytes": self.storage.total_bytes(),
                "budget_bytes": self.storage.budget_bytes,
                "put_rejected": self.storage.io_stats["put_rejected"],
                "per_tenant": {t: self.storage.tenant_bytes(t)
                               for t in self.tenants},
            },
            "maintenance": self.maintenance.stats(),
            "memory_bytes": self.memory_bytes(),
        }
