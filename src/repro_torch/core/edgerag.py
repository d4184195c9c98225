"""EdgeRAG index — the paper's contribution (§4, §5).

Port of ``repro.core.edgerag`` to PyTorch.  The index's bookkeeping stays on
the host in numpy, as in the JAX package; the centroid probe (``topk_ip``),
k-means and the slab scoring (``slab_topk``) run on the index's ``device``
(the card unless ``device="cpu"``).  Stored clusters may use any storage
codec (``storage_codec=`` fp32 / fp16 / int8 / pq, ``storage_mode=`` memory /
disk / memmap), or a storage backend and cache handed in (``storage=``,
``cache=``: a :class:`~repro_torch.core.tenant.TenantRouter`'s tenant
views).  A :class:`~repro_torch.core.durability.Durability` handle attached
with ``attach_durability`` logs one WAL record per public mutation; the
sharded ``mesh=`` route comes with a later slice.

Improves the two-level IVF index for memory-constrained serving:

  1. PRUNE second-level embeddings (they are generated at indexing time for
     clustering, then discarded) and regenerate them online at retrieval.
  2. SELECTIVE INDEX STORAGE (Alg. 1): clusters whose regeneration latency
     would exceed the SLO get their embeddings precomputed and persisted to
     storage; loads bypass the long tail of online generation.
  3. ADAPTIVE COST-AWARE CACHING (Alg. 2 + 3): regenerated embeddings are
     cached under a cost-weighted LFU policy with an adaptive minimum-
     latency admission threshold.
  4. Online INSERT / REMOVE with cluster split / merge (§5.4), made
     concurrent-safe with precomputed plans through GENERATION STAMPS and
     optionally deferred through the MaintenanceScheduler (see below).

Retrieval (Fig. 9): probe centroids → per probed cluster resolve embeddings
via storage / cache / regeneration → fused top-k → chunk ids.

Table 4 ablations map to constructor flags:
  IVF+Embed.Gen.        store_heavy=False  cache_bytes=0
  IVF+Embed.Gen.+Load   store_heavy=True   cache_bytes=0
  EdgeRAG               store_heavy=True   cache_bytes>0
Retrieval results are bit-identical across the three (and to the in-memory
IVF baseline): the paper's §6.3.1 claim, asserted in tests.

BATCHED RETRIEVAL (:meth:`EdgeRAGIndex.search_batch`): the serving fast
path for concurrent queries.  One fused centroid top-k runs over the whole
batch, the probed clusters are union-deduped across queries, and each
unique cluster is resolved exactly once per batch (storage → cache →
regenerate).  All cache-miss regenerations are coalesced into a SINGLE
``embed_fn`` call over the concatenated cluster texts, then split back per
cluster.  Per-query results are assembled from the shared resolutions in
each query's own probed order, so (ids, scores) are bit-identical to
running per-query ``search`` sequentially.

Latency attribution for shared resolutions: each unique cluster has an
OWNER — the lowest-index query in the batch that probed it.  The owner's
:class:`LatencyBreakdown` is charged the full resolution cost
(storage load / cache hit / generation, exactly the single-query formula);
every other query that probed the same cluster records a *shared hit*
(``n_shared_hits``) charged only a DRAM re-read (``l2_mem_load_s``) since
the embeddings are already resident.  The cache is consulted at most once
per unique cluster per batch (one counter bump + decay per access, as in
Alg. 2), and the Alg. 3 threshold observes once per query in batch order;
a query counts as a miss iff it owns at least one regenerated cluster.
``wall_s`` is the batch wall time amortized uniformly over the queries.
Single-query ``search`` is a thin wrapper over a batch of one — the
degenerate case reproduces the seed semantics exactly.

TIERED RESOLUTION (core/resolver.py): retrieval runs an explicit
probe → PLAN → EXECUTE → score pipeline.  :meth:`EdgeRAGIndex.plan_batch`
(or ``search_batch`` internally) builds a
:class:`~repro_torch.core.resolver.ResolutionPlan` — the batch's unique clusters,
each one's owner query and chosen tier (storage / cache / regen), and the
coalesced regeneration groups — and the shared
:class:`~repro_torch.core.resolver.ClusterResolver` executes it: a batched
``get_many`` storage load, cache lookups, one ``embed_fn`` call per regen
group.
A precomputed plan can be handed back to ``search_batch(plan=...)`` so the
serving engine can prefetch the plan's storage loads before prompt
assembly.

PACKED-SLAB SCORING (kernels/slab_topk + resolver.SlabLayout): the
second-level scoring step packs the batch's unique resolved clusters
exactly ONCE into contiguous slabs (one per storage representation, with
per-cluster (offset, length) extents and a parallel chunk-id slab) and
scores ALL queries in one ragged multi-query kernel launch per slab (fp16 /
int8 / pq slabs scored in their compact form, with fused dequantization or
PQ lookup tables) —
per-(query, row) membership and the per-query virtual concat order ride
in an int32 ``virt`` matrix whose entries double as the top-k tie-break
key, so the results equal a per-query concat + top-k loop while shared
clusters are copied once instead of once per probing query.  The kernel's
scores are batch-invariant, so inside the port a batch is bitwise equal to
its queries run one at a time.

PLAN-STALENESS CONTRACT (core/maintenance.py): every cluster carries a
monotonically increasing ``generation``, bumped by any mutation — insert,
remove, split, merge, restore, stored-copy drop.  A ``ResolutionPlan``
snapshots each planned cluster's generation, and ``execute`` regenerates
(never scores) any cluster whose generation moved between plan and
execution — including SAME-SIZE mutations the old row-count guard missed.
``stored_generation`` tracks which generation the storage copy reflects;
stale copies are bypassed and re-persisted.  A stale plan therefore always
degrades to regeneration over the clusters' *current* membership (or to
skipping clusters that were merged away), never to wrong ids.  Code that
mutates a cluster without going through insert / remove must bump
``generation`` itself.

Maintenance runs synchronously inside insert / remove by default
(``maintenance="sync"``, the seed behavior).  With
``maintenance="deferred"`` mutations only enqueue split / merge / restore
onto ``self.maintenance`` (a MaintenanceScheduler) and return fast; the
serving layer drains the queue between steps under an edge-cost budget.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cache_policy import (CostAwareLFUCache,
                                           MinLatencyThresholdController)
from repro_torch.core.costs import EdgeCostModel, LatencyBreakdown, WallTimer
from repro_torch.core.faults import DegradationPolicy
from repro_torch.core.kmeans import kmeans
from repro_torch.core.maintenance import (OP_DROP_STORE, OP_MERGE, OP_RESTORE,
                                          OP_SPLIT, MaintenanceScheduler)
from repro_torch.core.pq import PQCodebook, pq_luts
from repro_torch.core.resolver import (ClusterResolver, ResolutionPlan,
                                       SlabPayload)
from repro_torch.core.storage import StorageBackend
from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.kernels.ivf_topk.ops import topk_ip
from repro_torch.kernels.slab_topk.ops import NOT_PROBED, slab_topk


@dataclasses.dataclass
class EdgeCluster:
    ids: np.ndarray                 # (n,) chunk ids
    char_count: int                 # total chars across chunks
    gen_latency_est: float          # profiled regeneration latency (Alg. 1)
    stored: bool = False            # embeddings persisted to storage
    active: bool = True             # tombstone after merge
    generation: int = 0             # bumped on ANY mutation (plan staleness)
    content_generation: int = 0     # bumped only when membership/content
    # moves (insert / update / remove / split / merge) — storage-tier flips
    # (restore, drop) bump ``generation`` alone.  Fetched payloads stay
    # row-aligned across tier flips, so post-fetch staleness checks (the
    # pipeline's S3 replan gate) compare THIS stamp; fetch-time tier
    # decisions keep using ``generation`` (a dropped copy can't be loaded)
    stored_generation: int = -1     # generation the storage copy reflects

    @property
    def size(self) -> int:
        return len(self.ids)

    @property
    def storage_fresh(self) -> bool:
        """The stored copy (if any) reflects the current membership."""
        return self.stored and self.stored_generation == self.generation


@dataclasses.dataclass
class BatchSearchState:
    """In-flight state of a staged batched retrieval.

    :meth:`EdgeRAGIndex.search_batch` is split into three resumable stages
    so the serving pipeline (serving/pipeline.py) can interleave other
    work between them on the modeled clock:

      ``search_begin``   S1  probe + plan (+ per-query plan-time charges)
      ``search_fetch``   S2  raw payload resolution (storage / cache /
                             coalesced regeneration, fault retries/stalls)
      ``search_finish``  S3  slab pack + multi-query top-k scoring

    Calling the three back-to-back is exactly ``search_batch`` — same
    draws, same charges, bit-identical (ids, scores).
    """
    queries: np.ndarray                      # (Q, d) float32
    k: int
    plan: ResolutionPlan
    lats: List[LatencyBreakdown]
    missed: List[bool]
    payloads: Optional[Dict[int, SlabPayload]] = None
    wall_accum_s: float = 0.0                # summed stage wall times

    @property
    def nq(self) -> int:
        return self.queries.shape[0]

    @property
    def centroid_total_s(self) -> float:
        """Total centroid-search edge seconds of this batch's S1 — ONE
        fused launch for the batch."""
        return self.lats[0].centroid_search_s if self.lats else 0.0

    def shrink_deadlines(self, extra_wait_s: float):
        """Tighten every remaining per-query deadline by queue seconds that
        accrued after S1 (the serving layer's queue-wait adjustment)."""
        plan = self.plan
        if extra_wait_s > 0.0 and plan.deadlines is not None:
            plan.deadlines = [None if d is None else max(0.0, d - extra_wait_s)
                              for d in plan.deadlines]


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host-to-device copy of ``a`` in its own dtype.  Read-only arrays
    (memmap payloads) are copied on the host first: a tensor must not alias
    a read-only mapping (torch warns, and on the CPU ``.to`` would not
    copy)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def slab_score_topk(slab, queries: np.ndarray, k: int,
                    probed_per_q: Sequence[Sequence], *,
                    device: torch.device
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The S3 scoring core: ONE ragged multi-query top-k launch per slab
    segment (at most four: fp32 / fp16 / int8 / pq), segments merged per
    query under the virt tie-break.  Each segment goes to ``device`` in one
    copy in its own dtype (int8 with its scale column), as do the queries
    and the virt matrix; the (Q, k) results come back to the host.  PQ
    segments build the batch's ADC tables ONCE here (``pq_luts``) and score
    codes by in-kernel gather+accumulate.  Each (query, row) pair's result
    depends only on that query's member rows (the virt mask excludes
    everything else).  Returns ``(out_ids (Q,k), out_vals (Q,k), n_valid
    (Q,))``.
    """
    nq = queries.shape[0]
    out_ids = np.full((nq, k), -1, np.int64)
    out_vals = np.full((nq, k), -np.inf, np.float32)
    virts, n_valid, n_valid_seg = slab.query_layout(probed_per_q)
    lane = np.arange(k)[None, :]
    q_dev = _to_device(queries, device)
    cand_vals, cand_virt, cand_ids = [], [], []
    for seg in slab.segments:
        if seg.rows == 0:
            continue
        virt = virts[seg.kind]
        kw = {}
        if seg.scales is not None:
            kw["scales"] = _to_device(seg.scales, device)
        if seg.kind == "pq":                          # (Q, m, 256), once
            kw["luts"] = _to_device(pq_luts(seg.codebook, queries), device)
        vals, rows = slab_topk(_to_device(seg.emb, device), q_dev,
                               _to_device(virt, device), k, **kw)
        vals, rows = vals.cpu().numpy(), rows.cpu().numpy()
        # mask the padding lanes BEFORE the id gather and insist
        # every remaining row is in-range — the old path's np.clip
        # silently mapped any out-of-range index to the last id
        valid = lane < n_valid_seg[seg.kind][:, None]    # (Q, k)
        assert ((rows[valid] >= 0)
                & (rows[valid] < seg.rows)).all(), \
            "slab top-k returned out-of-range rows"
        rows = np.where(valid, rows, 0)
        cand_ids.append(np.where(valid, seg.ids[rows], -1))
        cand_vals.append(np.where(valid, vals, -np.inf))
        cand_virt.append(np.where(
            valid, virt[np.arange(nq)[:, None], rows],
            np.int32(NOT_PROBED)))
    if len(cand_vals) == 1:            # one representation
        out_vals[:, :] = cand_vals[0]
        out_ids[:, :] = cand_ids[0]
    elif cand_vals:                    # merge segments per query under
        cv = np.concatenate(cand_vals, axis=1)   # the same total
        ct = np.concatenate(cand_virt, axis=1)   # order the kernel
        ci = np.concatenate(cand_ids, axis=1)    # selected by
        order = np.lexsort((ct, -cv), axis=1)[:, :k]
        out_vals[:, :] = np.take_along_axis(cv, order, axis=1)
        out_ids[:, :] = np.take_along_axis(ci, order, axis=1)
    return out_ids, out_vals, n_valid


class EdgeRAGIndex:
    """Two-level pruned IVF with selective storage + adaptive caching."""

    def __init__(self, dim: int, embed_fn: Callable[[Sequence[str]], np.ndarray],
                 get_chunks: Callable[[Sequence[int]], List[str]],
                 cost_model: Optional[EdgeCostModel] = None,
                 *, slo_s: float = 1.0,
                 store_heavy: bool = True,
                 cache_bytes: Optional[int] = None,
                 storage_mode: str = "memory",
                 storage_codec: str = "fp32",
                 storage_root: Optional[str] = None,
                 split_max_chars: int = 200_000,
                 merge_min_size: int = 2,
                 maintenance: str = "sync",
                 maintenance_budget_s: Optional[float] = None,
                 device: DeviceLike = None,
                 storage=None, cache=None):
        assert maintenance in ("sync", "deferred"), maintenance
        self.device = resolve_device(device)
        self.dim = dim
        self.embed_fn = embed_fn
        self.get_chunks = get_chunks
        self.cost = cost_model or EdgeCostModel()
        self.slo_s = slo_s
        self.store_heavy = store_heavy
        # ``storage`` / ``cache`` inject SHARED substrates (a TenantRouter's
        # TenantStorageView / TenantCacheView); None keeps the owned ones
        if cache is not None:
            self.cache = cache
        else:
            if cache_bytes is None:
                cache_bytes = int(0.07 * self.cost.device_memory_bytes)
            self.cache = CostAwareLFUCache(cache_bytes)            # §6.3.4
        self.threshold = MinLatencyThresholdController()
        if storage is None:
            storage = StorageBackend(storage_mode, root=storage_root,
                                     codec=storage_codec, device=self.device)
        else:
            st_dev = torch.device("cuda" if storage.device is None
                                  else storage.device)
            if not same_device(st_dev, self.device):
                raise ValueError(
                    f"storage on {st_dev} for an index on {self.device}")
        self.storage = storage
        self.resolver = ClusterResolver(self)
        self.centroids: Optional[np.ndarray] = None
        self.clusters: List[EdgeCluster] = []
        self.split_max_chars = split_max_chars
        self.merge_min_size = merge_min_size
        self.maintenance_mode = maintenance
        self.maintenance = MaintenanceScheduler(
            self, budget_s_per_step=maintenance_budget_s)
        self._chunk_chars: Dict[int, int] = {}
        self._chunk_cluster: Dict[int, int] = {}   # chunk id -> cluster id
        # durability (core/durability.py): attached handle + the dirty set
        # the next _wal_commit() turns into ONE WAL record.  Mutation
        # helpers mark the clusters they touch; the PUBLIC op (insert /
        # update / remove / retrain_pq / a drained maintenance op / a
        # resolver self-heal) commits, so one op = one record whatever
        # cascade it triggered.
        self.durability = None
        self._dirty: set = set()
        self._gone: set = set()     # chunk ids deleted since last commit

    # ------------------------------------------------------------------
    # durability (core/durability.py)
    # ------------------------------------------------------------------
    def attach_durability(self, durability, *, checkpoint: bool = True):
        """Attach a :class:`~repro_torch.core.durability.Durability` handle:
        every finished mutation now emits one WAL record, and snapshots ride
        the maintenance queue as ``OP_CHECKPOINT`` ops.  ``checkpoint=True``
        takes the baseline snapshot now (recovery needs one to exist)."""
        self.durability = durability
        self._dirty.clear()
        self._gone.clear()
        durability.manifest = {
            cid: self.storage.payload_crc(cid)
            for cid, cl in enumerate(self.clusters)
            if cl.stored and cid in self.storage}
        if checkpoint:
            durability.checkpoint(self)
        return durability

    def _wal_commit(self, op: str) -> float:
        """Commit the accumulated dirty set as ONE WAL record carrying the
        absolute post-op state of every touched cluster; returns modeled
        fsync edge seconds (0 with no handle attached).  Blobs are always
        written BEFORE this runs, so a crash between blob and record
        orphans the blob (recovery GCs it back to pre-op) rather than ever
        leaving a hybrid."""
        dirty, gone = self._dirty, self._gone
        if self.durability is None or not (dirty or gone):
            dirty.clear()
            gone.clear()
            return 0.0
        cids = sorted(c for c in dirty if c < len(self.clusters))
        removed = sorted(gone)
        dirty.clear()
        gone.clear()
        return self.durability.log_mutation(self, op, cids, removed)

    # ------------------------------------------------------------------
    # indexing (Fig. 8 + Alg. 1)
    # ------------------------------------------------------------------
    def build(self, chunk_ids: Sequence[int], texts: Sequence[str],
              nlist: int, kmeans_iters: int = 20, seed: int = 0,
              embeddings: Optional[np.ndarray] = None):
        """Index a corpus.  ``embeddings`` may be passed if already computed
        (the paper computes them once for clustering, then prunes)."""
        if embeddings is None:
            embeddings = self.embed_fn(list(texts))
        embeddings = np.ascontiguousarray(embeddings, np.float32)
        centroids, assign = kmeans(embeddings, nlist, iters=kmeans_iters,
                                   seed=seed, device=self.device)
        self._install(chunk_ids, texts, embeddings, centroids, assign,
                      pq_seed=seed)
        return assign

    def _install(self, chunk_ids: Sequence[int], texts: Sequence[str],
                 embeddings: np.ndarray, centroids: np.ndarray,
                 assign: np.ndarray, *, pq_seed: int = 0,
                 pq_codebook: Optional[PQCodebook] = None):
        """Index a corpus under GIVEN first-level centroids and cluster
        assignments (``build`` after its k-means; ``convert`` loads another
        index's clustering this way).  Under the pq codec the codebook is
        trained on the whole corpus (seed ``pq_seed``) before the first put,
        or ``pq_codebook`` is adopted as it is.  Runs Alg. 1 on every
        cluster."""
        chunk_ids = np.asarray(chunk_ids, np.int64)
        embeddings = np.ascontiguousarray(embeddings, np.float32)
        assign = np.asarray(assign)
        # rebuild: drop every trace of the previous corpus — stored
        # clusters, cached embeddings, the adapted Alg. 3 threshold (learned
        # from the old latency distribution), and the char table
        self.storage.clear()
        self.maintenance.clear()        # queued ops describe the old corpus
        self.cache = self.cache.fresh()
        self.threshold = MinLatencyThresholdController(
            self.threshold.step_s, self.threshold.alpha)
        self._chunk_chars = {int(i): len(t)
                             for i, t in zip(chunk_ids, texts)}
        if self.storage.codec == "pq":
            # codebook lifecycle: TRAIN AT BUILD on the full corpus, before
            # any Alg. 1 put encodes against it (a rebuild retrains — the
            # version bump invalidates the cleared previous-corpus blobs).
            # On a SHARED backend (TenantStorageView) the codebook belongs
            # to the medium: the first tenant's build trains it and later
            # tenants reuse it (retraining would invalidate their
            # neighbours' blobs — that is retrain_pq's explicit job)
            shared = hasattr(self.storage, "backend")
            if pq_codebook is not None:
                self.storage.install_pq(pq_codebook)
            elif not (shared and self.storage.pq is not None):
                self.storage.train_pq(embeddings, seed=pq_seed)
        self.centroids = np.array(centroids, np.float32)
        self.clusters = []
        self._chunk_cluster = {}
        for c in range(self.centroids.shape[0]):
            sel = np.where(assign == c)[0]
            chars = int(sum(len(texts[j]) for j in sel))
            cl = EdgeCluster(ids=chunk_ids[sel], char_count=chars,
                             gen_latency_est=self.cost.embed_latency(chars))
            for i in cl.ids:
                self._chunk_cluster[int(i)] = len(self.clusters)
            # ---- Algorithm 1: Selective Index Storage ----
            # (a shared-budget refusal — put returns 0 — leaves the
            # cluster on the regeneration path)
            if (self.store_heavy and cl.gen_latency_est > self.slo_s
                    and self.storage.put(len(self.clusters),
                                         embeddings[sel]) > 0):
                cl.stored = True                           # heavy tail persisted
                cl.stored_generation = cl.generation
            self.clusters.append(cl)
        # second-level embeddings are now PRUNED (not retained in memory)
        if self.durability is not None:
            # a rebuild obsoletes every prior record: re-baseline with a
            # fresh manifest + snapshot (compaction drops the old WAL)
            self.attach_durability(self.durability, checkpoint=True)

    # ------------------------------------------------------------------
    # memory accounting
    # ------------------------------------------------------------------
    def memory_bytes(self) -> int:
        n = self.centroids.nbytes if self.centroids is not None else 0
        return n + self.cache.total_bytes()

    def storage_bytes(self) -> int:
        return self.storage.total_bytes()

    @property
    def nlist(self) -> int:
        return 0 if self.centroids is None else len(self.centroids)

    @property
    def ntotal(self) -> int:
        return sum(c.size for c in self.clusters if c.active)

    # ------------------------------------------------------------------
    # retrieval (Fig. 9): probe → plan → execute → score
    # ------------------------------------------------------------------
    def _probe(self, queries: np.ndarray, nprobe: int) -> List[List[int]]:
        """ONE fused centroid top-k over the batch; per query, the probed
        active non-empty clusters in probe order.

        Tombstoned (merged-away) and emptied-out clusters keep a centroid
        in the first level, so the top-k over-requests by their count and
        truncates back to ``nprobe`` after filtering — otherwise every such
        centroid that outranks a live one silently shrinks the probe set
        below ``nprobe`` (recall loss on merge-heavy indexes).  With no
        dead clusters this is exactly a ``min(nprobe, nlist)`` top-k.
        """
        n_dead = sum(not c.active or c.size == 0 for c in self.clusters)
        _, probed_all = topk_ip(
            torch.from_numpy(self.centroids).to(self.device),
            torch.from_numpy(queries).to(self.device),
            min(nprobe + n_dead, self.nlist))
        probed_all = probed_all.cpu().numpy()
        return [[int(c) for c in probed_all[qi]
                 if c >= 0 and self.clusters[int(c)].active
                 and self.clusters[int(c)].size > 0][:nprobe]
                for qi in range(queries.shape[0])]

    def _plan_with_deadlines(self, probed_per_q: List[List[int]],
                             deadlines: Optional[Sequence[Optional[float]]],
                             policy: Optional[DegradationPolicy],
                             query_chars: Optional[Sequence[int]]
                             ) -> ResolutionPlan:
        """Plan the probe lists, applying degradation rung 1 (shrink
        effective nprobe) first when deadline budgets are present.  The
        deadlines / policy / shed counts ride on the plan so execute-time
        rungs 2-3 and ``search_batch``'s accounting see them."""
        shed: Optional[List[int]] = None
        if deadlines is not None:
            nq = len(probed_per_q)
            assert len(deadlines) == nq, \
                f"{len(deadlines)} deadlines for {nq} queries"
            policy = policy or DegradationPolicy()
            centroid_s = (self.cost.mem_load_latency(self.centroids.nbytes)
                          + self.cost.search_latency(self.nlist, self.dim))
            base = [centroid_s
                    + (self.cost.embed_latency(int(query_chars[qi]))
                       if query_chars is not None and query_chars[qi]
                       else 0.0)
                    for qi in range(nq)]
            probed_per_q, shed = policy.trim_probes(self, probed_per_q,
                                                    deadlines, base)
        plan = self.resolver.plan(probed_per_q)
        if deadlines is not None:
            plan.deadlines = list(deadlines)
            plan.policy = policy
            plan.shed_probes = shed
        return plan

    def plan_batch(self, query_embs: np.ndarray, nprobe: int, *,
                   prefetch_storage: bool = False,
                   deadlines: Optional[Sequence[Optional[float]]] = None,
                   policy: Optional[DegradationPolicy] = None,
                   query_chars: Optional[Sequence[int]] = None
                   ) -> ResolutionPlan:
        """Probe + plan without executing — the serving engine uses this to
        issue the plan's storage loads before prompt assembly.  Hand the
        plan to ``search_batch(plan=...)`` to execute it (the plan-time
        cache lookups already happened; they are not repeated).

        ``deadlines``: optional per-query retrieval budgets (edge seconds,
        None entries = no deadline); the plan applies the degradation
        ladder's rung 1 (probe trimming, ``DegradationPolicy``) now and
        carries the budgets so execution can shed further."""
        queries = np.atleast_2d(np.asarray(query_embs, np.float32))
        plan = self._plan_with_deadlines(self._probe(queries, nprobe),
                                         deadlines, policy, query_chars)
        if prefetch_storage:
            self.resolver.prefetch(plan)
        return plan

    def search_batch(self, query_embs: np.ndarray, k: int, nprobe: int,
                     query_chars: Optional[Sequence[int]] = None,
                     *, plan: Optional[ResolutionPlan] = None,
                     deadlines: Optional[Sequence[Optional[float]]] = None,
                     policy: Optional[DegradationPolicy] = None,
                     mesh=None, shard_axis: str = "data"
                     ) -> Tuple[np.ndarray, np.ndarray,
                                List[LatencyBreakdown]]:
        """Batched retrieval fast path (see module docstring).

        ``query_embs`` (Q, d); returns (ids (Q, k), scores (Q, k), one
        :class:`LatencyBreakdown` per query).  Each unique probed cluster is
        resolved once for the whole batch through the tiered
        :class:`ClusterResolver` and all cache-miss regenerations coalesce
        into a single ``embed_fn`` call; per-query (ids, scores) are
        bit-identical to a sequential per-query ``search`` loop.

        ``plan``: a precomputed :class:`ResolutionPlan` from
        :meth:`plan_batch` (same queries / nprobe) — skips re-probing and
        re-planning.  ``deadlines`` / ``policy``: per-query retrieval
        budgets and degradation ladder knobs (core/faults.py); with a
        precomputed plan, pass the deadlines to :meth:`plan_batch` instead
        (they ride on the plan) — passing them here only attaches them if
        the plan carries none (rung 1 can no longer trim a fixed plan).
        ``mesh``: the sharded route comes with the multi-device slice of
        the port and raises :class:`NotImplementedError` until then.

        Internally this is the three staged steps ``search_begin`` (S1),
        ``search_fetch`` (S2), ``search_finish`` (S3) run back-to-back —
        the serving pipeline calls them individually to overlap the stages
        of different batches on the modeled clock.
        """
        state = self.search_begin(query_embs, k, nprobe, query_chars,
                                  plan=plan, deadlines=deadlines,
                                  policy=policy, mesh=mesh,
                                  shard_axis=shard_axis)
        self.search_fetch(state)
        return self.search_finish(state)

    def search_begin(self, query_embs: np.ndarray, k: int, nprobe: int,
                     query_chars: Optional[Sequence[int]] = None,
                     *, plan: Optional[ResolutionPlan] = None,
                     deadlines: Optional[Sequence[Optional[float]]] = None,
                     policy: Optional[DegradationPolicy] = None,
                     mesh=None, shard_axis: str = "data"
                     ) -> BatchSearchState:
        """Stage S1 of the staged retrieval: probe + plan.  Charges the
        query-embed and centroid-search edge costs and accounts plan-time
        probe sheds.  Returns the :class:`BatchSearchState` the later
        stages consume."""
        if mesh is not None:
            raise NotImplementedError(
                "the sharded mesh= route comes with the multi-device slice "
                "of the port")
        queries = np.atleast_2d(np.asarray(query_embs, np.float32))
        nq = queries.shape[0]
        lats = [LatencyBreakdown() for _ in range(nq)]
        with WallTimer() as t:
            if query_chars is not None:
                assert len(query_chars) == nq, \
                    f"query_chars has {len(query_chars)} entries for {nq} queries"
                for lat, qc in zip(lats, query_chars):
                    if qc:
                        lat.embed_query_s = self.cost.embed_latency(int(qc))
            # Step 1: probe (ONE fused centroid top-k) + plan the tiers
            if plan is None:
                plan = self._plan_with_deadlines(
                    self._probe(queries, nprobe), deadlines, policy,
                    query_chars)
            elif deadlines is not None and plan.deadlines is None:
                plan.deadlines = list(deadlines)
                plan.policy = policy
            probed_per_q = plan.probed_per_q
            assert len(probed_per_q) == nq, \
                f"plan covers {len(probed_per_q)} queries, got {nq}"
            centroid_s = (self.cost.mem_load_latency(self.centroids.nbytes)
                          + self.cost.search_latency(self.nlist, self.dim))
            for qi in range(nq):
                lats[qi].n_clusters_probed = len(probed_per_q[qi])
                lats[qi].centroid_search_s = centroid_s
            if plan.shed_probes:
                # rung-1 sheds happened at plan time, before these
                # LatencyBreakdowns existed — account for them now
                for qi, n_shed in enumerate(plan.shed_probes):
                    lats[qi].degraded_clusters += n_shed
        return BatchSearchState(queries=queries, k=k, plan=plan, lats=lats,
                                missed=[False] * nq, wall_accum_s=t.elapsed)

    def search_fetch(self, state: BatchSearchState) -> BatchSearchState:
        """Stage S2: resolve the plan's unique clusters to RAW payloads —
        batched storage ``get_many_raw``, cache payloads, one
        coalesced regeneration per regen group (plus any fault retries /
        stalls / degradation sheds).  Owners are charged the single-query
        tier formulas."""
        with WallTimer() as t:
            state.payloads = self.resolver.execute(
                state.plan, state.lats, state.missed, raw=True)
        state.wall_accum_s += t.elapsed
        return state

    def search_finish(self, state: BatchSearchState
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 List[LatencyBreakdown]]:
        """Stage S3: pack the resolved payloads into the batch slab and
        score — ONE ragged multi-query top-k launch per storage
        representation — then run the Alg. 3 threshold observations."""
        assert state.payloads is not None, "search_fetch has not run"
        queries, k, plan, lats, missed = (state.queries, state.k, state.plan,
                                          state.lats, state.missed)
        nq = state.nq
        probed_per_q = plan.probed_per_q
        with WallTimer() as t:
            # Pack every unique cluster exactly once into the batch slab;
            # owners are charged the pack copy once per slab.
            slab = self.resolver.pack_slab(plan, state.payloads, lats)
            # Non-owners re-read the already-resident embeddings from DRAM
            # (resident set is invariant here: nothing mutates the cache
            # between pack_slab() and scoring, so hoist the byte count)
            owner = plan.owner
            resident = self.memory_bytes()
            for qi, probed in enumerate(probed_per_q):
                for cid in probed:
                    if owner[cid] != qi:
                        lats[qi].l2_mem_load_s += self.cost.mem_load_latency(
                            slab.nbytes(cid), resident_bytes=resident)
                        lats[qi].n_shared_hits += 1
            # Step 6: packed-slab scoring — ONE ragged multi-query launch
            # per storage representation (slab_score_topk)
            out_ids, out_vals, n_valid = slab_score_topk(
                slab, queries, k, probed_per_q, device=self.device)
            # PQ segments: every query's ADC tables are built once per
            # batch (l2_pq_lut_s) — charged INSTEAD of any dequant
            has_pq = any(seg.kind == "pq" and seg.rows
                         for seg in slab.segments)
            for qi in range(nq):
                if has_pq:
                    lats[qi].l2_pq_lut_s += self.cost.pq_lut_latency(self.dim)
                if n_valid[qi]:
                    lats[qi].l2_search_s = self.cost.search_latency(
                        int(n_valid[qi]), self.dim)
        state.wall_accum_s += t.elapsed
        for lat in lats:                       # amortized batch wall time
            lat.wall_s = state.wall_accum_s / nq
        # ---- Algorithm 3: adapt the threshold, once per query in order
        # (queries that probed nothing did no level-2 work: no observation,
        # matching the single-query early-return) ----
        for qi in range(nq):
            if not probed_per_q[qi]:
                continue
            new_thr = self.threshold.observe(missed[qi], lats[qi].retrieval_s)
            if missed[qi]:
                self.cache.drop_below_threshold(new_thr)
        return out_ids, out_vals, lats

    def search(self, query_emb: np.ndarray, k: int, nprobe: int,
               query_chars: int = 0, *,
               deadline_s: Optional[float] = None,
               policy: Optional[DegradationPolicy] = None
               ) -> Tuple[np.ndarray, np.ndarray, LatencyBreakdown]:
        """Single query — the degenerate batch of one."""
        query = np.atleast_2d(np.asarray(query_emb, np.float32))
        assert query.shape[0] == 1
        ids, vals, lats = self.search_batch(
            query, k, nprobe,
            query_chars=[query_chars] if query_chars else None,
            deadlines=None if deadline_s is None else [deadline_s],
            policy=policy)
        return ids, vals, lats[0]

    # ------------------------------------------------------------------
    # online updates (§5.4)
    # ------------------------------------------------------------------
    def insert(self, chunk_id: int, text: str,
               embedding: Optional[np.ndarray] = None) -> int:
        """Insert one chunk; returns the cluster id it LANDED in (after any
        split moved it).  In deferred mode the heavy follow-up work
        (restore / split) is queued on ``self.maintenance`` instead of
        running inline."""
        if embedding is None:
            embedding = self.embed_fn([text])[0]
        embedding = np.asarray(embedding, np.float32)
        # assignment by the same un-normalized inner product that build's
        # spherical k-means and the retrieval probe use (centroids are
        # unit-norm, so ordering is scale-invariant): normalizing here
        # rounds differently than the probe's raw IP and can flip near-ties,
        # landing a chunk in a cluster its own embedding never probes.
        # Tombstoned clusters are excluded — their buried centroids can
        # outrank every live one (see _probe), and a chunk appended to an
        # inactive cluster would be silently unretrievable.
        active_idx = np.array([j for j, c in enumerate(self.clusters)
                               if c.active], np.int64)
        _, idx = topk_ip(
            torch.from_numpy(self.centroids[active_idx]).to(self.device),
            torch.from_numpy(embedding[None]).to(self.device), 1)
        cid = int(active_idx[int(idx[0, 0])])
        cl = self.clusters[cid]
        cl.ids = np.append(cl.ids, np.int64(chunk_id))
        cl.char_count += len(text)
        cl.generation += 1
        cl.content_generation += 1
        self._chunk_chars[int(chunk_id)] = len(text)
        self._chunk_cluster[int(chunk_id)] = cid
        cl.gen_latency_est = self.cost.embed_latency(cl.char_count)
        self.cache.invalidate(cid)                      # stale embeddings
        if cl.char_count > self.split_max_chars:
            # a pending split supersedes a restore: the split re-persists
            # its parts per Alg. 1 itself, so restoring first would
            # regenerate + write a copy the split immediately deletes
            ops = [(OP_SPLIT, cid)]
        elif self.store_heavy and cl.gen_latency_est > self.slo_s:
            ops = [(OP_RESTORE, cid)]                   # regenerate + persist
        else:
            ops = []
        self._dirty.add(cid)
        self._dispatch_maintenance(ops)
        self._wal_commit("insert")
        # a synchronous split may have moved the chunk to the appended slot
        return self._chunk_cluster[int(chunk_id)]

    def update(self, chunk_id: int, text: str) -> Optional[int]:
        """Re-embed one chunk IN PLACE (§5.4 online update): same id, same
        cluster, same row count — only the content moved.  Returns the
        cluster id, or None for an unknown chunk.  The cluster's generation
        bumps, so cached embeddings are invalidated and any stored copy
        goes stale (a deferred restore refreshes it; until then the
        degradation ladder may serve the old copy FLAGGED as stale — unlike
        insert/remove churn it still row-aligns with the cluster)."""
        cid = self._chunk_cluster.get(int(chunk_id))
        if cid is None:
            return None
        cl = self.clusters[cid]
        cl.char_count += len(text) - self._chunk_chars.get(int(chunk_id), 0)
        self._chunk_chars[int(chunk_id)] = len(text)
        cl.generation += 1
        cl.content_generation += 1
        cl.gen_latency_est = self.cost.embed_latency(cl.char_count)
        self.cache.invalidate(cid)                      # stale embeddings
        if cl.char_count > self.split_max_chars:
            ops = [(OP_SPLIT, cid)]                     # supersedes restore
        elif self.store_heavy and cl.gen_latency_est > self.slo_s:
            ops = [(OP_RESTORE, cid)]                   # refresh stale copy
        elif cl.stored:
            ops = [(OP_DROP_STORE, cid)]                # became cheap
        else:
            ops = []
        self._dirty.add(cid)
        self._dispatch_maintenance(ops)
        self._wal_commit("update")
        return cid

    def remove(self, chunk_id: int) -> Optional[int]:
        # O(1) lookup through the chunk->cluster map (kept consistent by
        # build / insert / remove / split / merge)
        cid = self._chunk_cluster.get(int(chunk_id))
        if cid is None:
            return None
        cl = self.clusters[cid]
        pos = np.where(cl.ids == chunk_id)[0]
        if not cl.active or len(pos) == 0:      # defensive: stale map entry
            self._chunk_cluster.pop(int(chunk_id), None)
            return None
        cl.ids = np.delete(cl.ids, pos)
        cl.char_count -= self._chunk_chars.pop(int(chunk_id), 0)
        cl.generation += 1
        cl.content_generation += 1
        del self._chunk_cluster[int(chunk_id)]
        cl.gen_latency_est = self.cost.embed_latency(cl.char_count)
        self.cache.invalidate(cid)
        ops = []
        if cl.char_count > self.split_max_chars:
            # a cluster oversized since build (build never splits) heals on
            # first touch, keeping the split bound a true invariant for
            # every mutated cluster; the split supersedes any restore/drop
            # (it re-persists its parts per Alg. 1 itself)
            ops.append((OP_SPLIT, cid))
        elif cl.stored:
            if cl.gen_latency_est <= self.slo_s:
                # cheap again: drop the stored copy entirely (deferred mode
                # finally does this "async in the paper" work off-path)
                ops.append((OP_DROP_STORE, cid))
            else:
                ops.append((OP_RESTORE, cid))
        if 0 < cl.size < self.merge_min_size:
            ops.append((OP_MERGE, cid))
        self._dirty.add(cid)
        self._gone.add(int(chunk_id))
        self._dispatch_maintenance(ops)
        self._wal_commit("remove")
        return cid

    # ---- maintenance helpers (shared by sync mode and the scheduler) ----
    def _dispatch_maintenance(self, ops):
        """Run follow-up work inline (sync mode) or queue it (deferred).
        Sync split finishes the whole cascade now; the scheduler budgets
        split follow-ups across drains instead."""
        sync_apply = {OP_RESTORE: self._restore_cluster,
                      OP_DROP_STORE: self._drop_stored,
                      OP_SPLIT: self._split_cluster,
                      OP_MERGE: self._merge_cluster}
        for kind, cid in ops:
            if self.maintenance_mode == "sync":
                sync_apply[kind](cid)
            else:
                self.maintenance.enqueue(kind, cid)

    def _regen_embeddings(self, cid: int) -> np.ndarray:
        return self.resolver.regenerate([cid])[0]

    def _restore_cluster(self, cid: int):
        embs = self._regen_embeddings(cid)
        cl = self.clusters[cid]
        cl.generation += 1              # storage state is cluster state
        if self.storage.put(cid, embs) > 0:
            cl.stored = True
            cl.stored_generation = cl.generation
        else:                           # shared storage budget refused
            cl.stored = False
            cl.stored_generation = -1
        self._dirty.add(cid)

    def _drop_stored(self, cid: int):
        """The inverse of a restore: the cluster became cheap to regenerate,
        so its storage copy is dead weight."""
        cl = self.clusters[cid]
        cl.generation += 1
        self.storage.delete(cid)
        cl.stored = False
        cl.stored_generation = -1
        self._dirty.add(cid)

    def retrain_pq(self, embeddings: np.ndarray, *, seed: int = 0):
        """Drift retrain of the PQ codebook (train at build, RETRAIN ON
        DRIFT).  Bumps the codebook version — every stored blob is now
        stale (its ``cbv`` pins the old version) — then routes one restore
        per stored cluster through the maintenance path (inline under
        ``maintenance='sync'``, queued under ``'deferred'``): regenerate at
        full precision, re-encode under the new codebook, re-persist.  A
        read racing an un-restored blob is safe: the stale payload
        quarantine-drops and falls back to regeneration."""
        if self.storage.codec != "pq":
            raise ValueError("retrain_pq requires the pq storage codec")
        self.storage.train_pq(embeddings, seed=seed)
        for cid, cl in enumerate(self.clusters):
            if not (cl.active and cl.stored):
                continue
            cl.generation += 1
            cl.stored_generation = -1       # stale under the new codebook
            self._dirty.add(cid)
            if self.maintenance_mode == "sync":
                self._restore_cluster(cid)
            else:
                self.maintenance.enqueue(OP_RESTORE, cid)
        self._wal_commit("retrain_pq")

    def _reconcile_storage(self, cid: int):
        """Make the Alg. 1 invariant true for one cluster: (re)store it if
        regeneration is over-SLO and the copy is missing/stale, drop the
        copy if it became cheap.  The fallback when a split that superseded
        a restore turns out to be degenerate."""
        cl = self.clusters[cid]
        if not cl.active or cl.size == 0:
            if cl.stored:
                self._drop_stored(cid)
            return
        if self.store_heavy and cl.gen_latency_est > self.slo_s:
            if not (cl.storage_fresh and cid in self.storage):
                self._restore_cluster(cid)
        elif cl.stored:
            self._drop_stored(cid)

    def _split_cluster(self, cid: int):
        """Split an oversized cluster (k-means k=2 on regenerated
        embeddings), cascading until every produced part fits
        ``split_max_chars`` (or is a single un-splittable chunk)."""
        work = [cid]
        while work:
            c = work.pop()
            produced = self._split_once(c)
            if not produced:
                # degenerate split (duplicate embeddings): the cluster
                # stays oversized, but the storage reconciliation the
                # split superseded must still happen
                self._reconcile_storage(c)
                continue
            for slot in produced:
                cl = self.clusters[slot]
                if cl.char_count > self.split_max_chars and cl.size >= 2:
                    work.append(slot)

    def _split_once(self, cid: int) -> List[int]:
        """One split level: replace ``cid`` with part 0, append part 1.
        Returns the slots written (empty if the split was degenerate)."""
        cl = self.clusters[cid]
        embs = self._regen_embeddings(cid)
        if len(embs) < 2:
            return []
        cents, assign = kmeans(embs, 2, iters=10, seed=len(self.clusters),
                               device=self.device)
        texts = self.get_chunks(cl.ids.tolist())
        parts = []
        for half in (0, 1):
            sel = np.where(assign == half)[0]
            chars = int(sum(len(texts[j]) for j in sel))
            parts.append((cl.ids[sel], chars, embs[sel]))
        if any(len(p[0]) == 0 for p in parts):
            return []
        # replace cid with part 0; append part 1
        self.storage.delete(cid)
        self.cache.invalidate(cid)
        self._dirty.add(cid)
        self._dirty.add(len(self.clusters))     # the appended part's slot
        slots = []
        next_gen = cl.generation + 1    # both parts outlive any plan of cid
        for slot, (ids, chars, sub) in zip(
                (cid, len(self.clusters)), parts):
            newcl = EdgeCluster(ids=ids, char_count=chars,
                                gen_latency_est=self.cost.embed_latency(chars),
                                generation=next_gen,
                                content_generation=cl.content_generation + 1)
            if (self.store_heavy and newcl.gen_latency_est > self.slo_s
                    and self.storage.put(slot, sub) > 0):
                newcl.stored = True
                newcl.stored_generation = newcl.generation
            if slot == cid:
                self.clusters[cid] = newcl
                self.centroids[cid] = cents[0]
            else:
                self.clusters.append(newcl)
                self.centroids = np.concatenate(
                    [self.centroids, cents[1:2]])
            for i in newcl.ids:
                self._chunk_cluster[int(i)] = slot
            slots.append(slot)
        return slots

    def _merge_target(self, cid: int) -> Optional[int]:
        """The nearest active neighbor an undersized cluster would merge
        into (None if no candidate) — shared by the merge itself and the
        scheduler's cost estimate."""
        if self.nlist < 2:
            return None
        mask = np.ones(self.nlist, bool)
        mask[cid] = False
        for j, other in enumerate(self.clusters):
            if not other.active:
                mask[j] = False
        if not mask.any():
            return None
        sims = self.centroids @ self.centroids[cid]
        sims[~mask] = -np.inf
        return int(np.argmax(sims))

    def _merge_cluster(self, cid: int):
        """Merge an undersized cluster into its nearest active neighbor."""
        cl = self.clusters[cid]
        tgt = self._merge_target(cid)
        if tgt is None or cl.size == 0:
            return
        other = self.clusters[tgt]
        self._dirty.add(cid)
        self._dirty.add(tgt)
        other.ids = np.concatenate([other.ids, cl.ids])
        other.char_count += cl.char_count
        other.generation += 1
        other.content_generation += 1
        for i in cl.ids:
            self._chunk_cluster[int(i)] = tgt
        other.gen_latency_est = self.cost.embed_latency(other.char_count)
        self.cache.invalidate(tgt)
        self.cache.invalidate(cid)
        self.storage.delete(cid)
        cl.stored = False               # the copy just deleted is gone
        cl.stored_generation = -1
        # absorbing the merged chunks may push the survivor over the split
        # bound; the dispatched split then supersedes the restore (it
        # re-persists its parts itself — restoring first would regenerate
        # and write a copy the split immediately deletes)
        will_split = (other.char_count > self.split_max_chars
                      and other.size >= 2)
        if not will_split and (other.stored
                               or (self.store_heavy
                                   and other.gen_latency_est > self.slo_s)):
            self._restore_cluster(tgt)
        cl.active = False
        cl.ids = np.zeros((0,), np.int64)
        cl.char_count = 0
        cl.generation += 1              # tombstoning invalidates plans too
        cl.content_generation += 1
        self.centroids[cid] = -np.ones(self.dim) / np.sqrt(self.dim)  # bury
        if will_split:
            self._dispatch_maintenance([(OP_SPLIT, tgt)])

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        active = [c for c in self.clusters if c.active]
        n_stored_rows = sum(c.size for c in active if c.stored)
        return {
            "nlist": self.nlist,
            "active_clusters": len(active),
            "ntotal": self.ntotal,
            "stored_clusters": sum(c.stored for c in active),
            "memory_bytes": self.memory_bytes(),
            "storage_bytes": self.storage_bytes(),
            "storage_codec": self.storage.codec,
            # fp32-equivalent footprint of the stored rows — the reduction
            # denominator for quantized codecs
            "storage_fp32_bytes": n_stored_rows * self.dim * 4,
            "cache_entries": len(self.cache),
            "cache_hit_rate": self.cache.hit_rate,
            "threshold_s": self.threshold.threshold,
            "maintenance_pending": len(self.maintenance),
            "maintenance_edge_s": self.maintenance.total_edge_s,
        }
