"""Tiered cluster-resolution pipeline: probe → PLAN → EXECUTE → score.

Port of ``repro.core.resolver``.  The slab is packed on the host as in the
JAX package, one segment per storage representation (fp32 / fp16 / int8 /
pq); ``slab_score_topk`` sends one copy of each segment to the index's
device in the segment's own dtype.

EdgeRAG's central decision — where does a probed cluster's embedding matrix
come from? — used to live inline in ``EdgeRAGIndex.search_batch``.  This
module makes it an explicit subsystem shared by every consumer (single-query
``search``, ``search_batch``, maintenance regeneration, and the serving
engine's prefetch hook):

  PLAN     :meth:`ClusterResolver.plan` union-dedups the batch's probed
           clusters (owner = lowest-index query that probed each one) and
           chooses a TIER per unique cluster, walking the tier ladder:

             storage   selective index storage (Alg. 1, core/storage.py)
             cache     cost-aware LFU DRAM cache (Alg. 2); the plan-time
                       lookup is the batch's single counter-bump + decay
             regen     coalesced online regeneration — pending clusters are
                       packed into groups, ONE ``embed_fn`` call per group
                       (one group unless ``max_group_chars`` bounds it)

  EXECUTE  :meth:`ClusterResolver.execute` materializes the plan: a batched
           ``get_many`` storage load (or the plan's prefetched payloads),
           cached matrices, then the coalesced regenerations — charging each
           owner's :class:`LatencyBreakdown` with exactly the single-query
           cost formulas.  A storage key that vanished between plan and
           execute (e.g. a deleted cluster file) falls back to regeneration
           instead of crashing.

STALENESS (core/maintenance.py): the plan snapshots every planned cluster's
``generation`` stamp.  At execute time, any cluster whose generation moved —
an insert, remove, split, merge, restore or stored-copy drop landed between
plan and execution — abandons its planned payload and regenerates over the
cluster's CURRENT membership (clusters merged away resolve to zero rows and
drop out of scoring).  Generations catch same-size mutations; the old
row-count compare is kept only as defense in depth against direct mutators
that forgot to bump.  Stored clusters are additionally only loadable while
``stored_generation == generation`` — a stale or vanished copy is bypassed,
regenerated, and re-persisted (the Alg. 1 self-heal).

The fp32 tier is bit-identical to the pre-refactor inlined logic: the same
state mutations happen in the same order (cache access per unique cluster at
plan time, inserts after regeneration, per-field latency accumulation in
owner order), asserted by the Table-4 parity tests.

PACKED-SLAB SCORING (kernels/slab_topk): :meth:`ClusterResolver.execute_slab`
runs ``execute`` in RAW mode (storage payloads as stored,
``StorageBackend.get_many_raw``) and packs every resolved cluster exactly
once into a :class:`SlabLayout`: one contiguous (N_total, d) embedding slab
per storage representation present in the batch (fp16 / int8 payloads stay
undecoded, int8 with its per-row scale column; pq payloads as their uint8
codes plus the backend's codebook), a parallel chunk-id slab, and
per-cluster (offset, length) extents.  Scoring then runs ONE ragged
multi-query kernel launch per segment instead of Q concat-and-top-k rounds.
Owners are charged the slab-pack copy (``l2_slab_pack_s``) once per slab,
not once per probing query, plus the in-kernel decode of fp16 / int8 rows
(``l2_fused_dequant_s``) or the PQ code gather (``l2_pq_gather_s``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costs import LatencyBreakdown
from repro_torch.core.faults import DegradationPolicy, IOOutcome
from repro_torch.core.pq import PQCodebook
from repro_torch.kernels.slab_topk.ref import NOT_PROBED

TIER_STORAGE = "storage"
TIER_CACHE = "cache"
TIER_REGEN = "regen"


@dataclasses.dataclass
class ResolutionPlan:
    """Explicit per-batch resolution decisions (see module docstring).

    ``owner`` iterates in batch order (dict insertion order: by owning
    query, then that query's probe order) — execution replays charges in
    exactly this order.
    """
    probed_per_q: List[List[int]]        # per query: probed active clusters
    owner: Dict[int, int]                # cluster id -> owning query index
    tier: Dict[int, str]                 # cluster id -> chosen tier
    storage_clusters: List[int]          # storage tier, owner order
    cached: Dict[int, np.ndarray]        # cache tier: plan-time lookups
    regen_groups: List[List[int]]        # one coalesced embed call per group
    restore: List[int] = dataclasses.field(default_factory=list)
    # ^ regen-tier clusters whose storage copy vanished or went stale
    #   out-of-band: execution re-persists them (the Alg. 1 self-heal)
    generations: Dict[int, int] = dataclasses.field(default_factory=dict)
    # ^ plan-time generation stamp per planned cluster; execute() treats any
    #   mismatch with the live cluster as a stale plan entry
    content_generations: Dict[int, int] = \
        dataclasses.field(default_factory=dict)
    # ^ plan-time CONTENT stamp (membership/content mutations only, not
    #   storage-tier flips) — the post-fetch staleness check: payloads
    #   already fetched stay row-aligned across restore/drop, so only a
    #   content move forces the pipeline's S3 replan
    prefetched: Optional[Dict[int, Dict[str, np.ndarray]]] = None
    # ^ early storage loads — RAW payloads as stored
    io_outcomes: Optional[Dict[int, IOOutcome]] = None
    # ^ prefetch-time per-key I/O costs (retries / stalls / backoff): the
    #   charges belong to the owning query's LatencyBreakdown, which only
    #   exists at execute time
    deadlines: Optional[List[Optional[float]]] = None
    # ^ per-query retrieval deadline budgets (edge seconds; None = no
    #   deadline).  Set when the caller requested deadline-aware serving.
    policy: Optional[DegradationPolicy] = None
    # ^ the degradation ladder knobs; only consulted when deadlines is set
    shed_probes: List[int] = dataclasses.field(default_factory=list)
    # ^ rung-1 sheds per query (probes dropped before planning), recorded
    #   here because the per-query LatencyBreakdowns don't exist at plan
    #   time; search_batch folds them into ``degraded_clusters``

    def fresh(self, cid: int, cluster) -> bool:
        """True iff ``cluster`` has not mutated since this plan was made
        (missing snapshot = plan predates generation stamps: trust it)."""
        return self.generations.get(cid, cluster.generation) \
            == cluster.generation

    def content_fresh(self, cid: int, cluster) -> bool:
        """True iff ``cluster``'s MEMBERSHIP/CONTENT has not moved since
        plan time — storage-tier flips (restore / drop) don't count.  The
        right staleness predicate once payloads are already in hand."""
        return self.content_generations.get(
            cid, cluster.content_generation) == cluster.content_generation

    @property
    def regen_clusters(self) -> List[int]:
        return [cid for group in self.regen_groups for cid in group]

    @property
    def n_unique(self) -> int:
        return len(self.owner)


@dataclasses.dataclass
class SlabPayload:
    """One resolved cluster in its scoring representation.

    ``kind`` is the slab segment it packs into: "fp32" (cache / regen /
    fp32 storage), "fp16", "int8", or "pq" (undecoded storage payloads).
    ``scales`` is the int8 codec's per-row scale column, (n, 1) f32; for
    "pq", ``emb`` holds the (n, m) uint8 code matrix and ``codebook`` the
    backend's :class:`~repro_torch.core.pq.PQCodebook` the codes index into.
    """
    kind: str
    emb: np.ndarray
    scales: Optional[np.ndarray] = None
    codebook: Optional[PQCodebook] = None   # kind == "pq" only

    @property
    def rows(self) -> int:
        return len(self.emb)

    @property
    def nbytes(self) -> int:
        return self.emb.nbytes + (0 if self.scales is None
                                  else self.scales.nbytes)

    @classmethod
    def from_raw(cls, payload: Dict[str, np.ndarray],
                 codebook: Optional[PQCodebook] = None) -> "SlabPayload":
        """Wrap an undecoded ``StorageBackend`` codec payload."""
        if "q" in payload:
            return cls("int8", payload["q"],
                       np.ascontiguousarray(payload["scale"], np.float32))
        if "codes" in payload:
            if codebook is None:
                raise ValueError("a pq payload needs its codebook")
            return cls("pq", payload["codes"], codebook=codebook)
        emb = payload["emb"]
        if emb.dtype == np.float16:
            return cls("fp16", emb)
        return cls("fp32", np.ascontiguousarray(emb, np.float32))


@dataclasses.dataclass
class SlabSegment:
    """One contiguous packed slab: every cluster of one representation."""
    kind: str                       # "fp32" | "fp16" | "int8" | "pq"
    emb: np.ndarray                 # (rows, d) packed, segment dtype —
    #                                 (rows, m) uint8 codes for "pq"
    scales: Optional[np.ndarray]    # (rows, 1) f32 — int8 segments only
    ids: np.ndarray                 # (rows,) int64 parallel chunk-id slab
    clusters: List[int]             # cluster ids in pack order
    codebook: Optional[PQCodebook] = None   # pq segments only

    @property
    def rows(self) -> int:
        return len(self.emb)


@dataclasses.dataclass
class SlabLayout:
    """The batch's unique resolved clusters, each packed exactly ONCE.

    ``extent`` maps cluster id -> (kind, row offset, row length) into the
    segment of that representation; clusters that resolved to zero rows
    (merged away between plan and execute) get a zero-length extent and
    never reach scoring.  At most four segments exist (fp32 / fp16 / int8 /
    pq); a pure-fp32 batch packs one.
    """
    dim: int
    segments: List[SlabSegment]
    extent: Dict[int, Tuple[str, int, int]]

    @property
    def total_rows(self) -> int:
        return sum(seg.rows for seg in self.segments)

    def segment(self, kind: str) -> SlabSegment:
        return next(seg for seg in self.segments if seg.kind == kind)

    def view(self, cid: int) -> np.ndarray:
        """The cluster's packed rows — a VIEW into its segment's slab."""
        kind, off, length = self.extent[cid]
        if length == 0:
            return np.zeros((0, self.dim), np.float32)
        return self.segment(kind).emb[off:off + length]

    def nbytes(self, cid: int) -> int:
        """Resident (packed) bytes of one cluster — what a peer query's
        shared-hit DRAM re-read streams."""
        kind, off, length = self.extent[cid]
        if length == 0:
            return 0
        seg = self.segment(kind)
        n = length * seg.emb.shape[1] * seg.emb.itemsize
        if seg.scales is not None:
            n += length * seg.scales.itemsize
        return n

    @classmethod
    def pack(cls, dim: int, order: Sequence[int],
             payloads: Dict[int, SlabPayload],
             ids_of) -> "SlabLayout":
        """Pack ``payloads`` (in ``order``) into per-kind segments.

        ``ids_of(cid)`` supplies the cluster's current chunk ids; the
        staleness guards upstream guarantee they align with the payload
        rows (asserted here as defense in depth).

        A single-cluster segment adopts its payload array as the slab by
        reference instead of copying — with memmap-mode storage the slab is
        then a slice of the on-disk mapping.
        """
        by_kind: Dict[str, List[int]] = {}
        extent: Dict[int, Tuple[str, int, int]] = {}
        for cid in order:
            p = payloads[cid]
            if p.rows == 0:
                extent[cid] = (p.kind, 0, 0)
                continue
            by_kind.setdefault(p.kind, []).append(cid)
        segments: List[SlabSegment] = []
        for kind, cids in by_kind.items():
            first = payloads[cids[0]]
            cb = first.codebook if kind == "pq" else None
            if len(cids) == 1:
                cid = cids[0]
                cl_ids = ids_of(cid)
                assert len(cl_ids) == first.rows, \
                    f"cluster {cid}: {len(cl_ids)} ids vs {first.rows} rows"
                extent[cid] = (kind, 0, first.rows)
                segments.append(SlabSegment(
                    kind=kind, emb=first.emb, scales=first.scales,
                    ids=np.asarray(cl_ids, np.int64), clusters=[cid],
                    codebook=cb))
                continue
            rows = sum(payloads[c].rows for c in cids)
            d = first.emb.shape[1]
            emb = np.empty((rows, d), first.emb.dtype)
            scales = (np.empty((rows, 1), np.float32) if kind == "int8"
                      else None)
            ids = np.empty((rows,), np.int64)
            off = 0
            for cid in cids:
                p = payloads[cid]
                cl_ids = ids_of(cid)
                assert len(cl_ids) == p.rows, \
                    f"cluster {cid}: {len(cl_ids)} ids vs {p.rows} rows"
                emb[off:off + p.rows] = p.emb
                ids[off:off + p.rows] = cl_ids
                if scales is not None:
                    scales[off:off + p.rows] = p.scales
                extent[cid] = (kind, off, p.rows)
                off += p.rows
            segments.append(SlabSegment(kind=kind, emb=emb, scales=scales,
                                        ids=ids, clusters=list(cids),
                                        codebook=cb))
        return cls(dim=dim, segments=segments, extent=extent)

    def query_layout(self, probed_per_q: Sequence[Sequence[int]]):
        """Per-(query, cluster) membership from the plan's probe lists.

        Returns ``(virts, n_valid, n_valid_seg)``: ``virts`` maps each
        segment kind to a (Q, rows) int32 matrix whose entry is the row's
        position in that query's VIRTUAL per-query concatenation (probed
        clusters in probe order) or ``NOT_PROBED``; ``n_valid`` (Q,) is
        each query's total member-row count across segments (its virtual
        concat length), and ``n_valid_seg`` maps kind -> (Q,) per-segment
        member counts (the valid-lane bound for that segment's top-k
        output).  virt is both the scoring mask and the tie-break key that
        keeps slab results identical to the per-query concat loop.
        """
        nq = len(probed_per_q)
        virts = {seg.kind: np.full((nq, seg.rows), NOT_PROBED, np.int32)
                 for seg in self.segments}
        n_valid = np.zeros((nq,), np.int64)
        n_valid_seg = {seg.kind: np.zeros((nq,), np.int64)
                       for seg in self.segments}
        for qi, probed in enumerate(probed_per_q):
            base = 0
            for cid in probed:
                kind, off, length = self.extent[cid]
                if length == 0:
                    continue
                virts[kind][qi, off:off + length] = np.arange(
                    base, base + length, dtype=np.int32)
                base += length
                n_valid_seg[kind][qi] += length
            n_valid[qi] = base
        return virts, n_valid, n_valid_seg


class ClusterResolver:
    """Executes the tier ladder for an :class:`EdgeRAGIndex`.

    ``max_group_chars`` bounds the text volume of one coalesced ``embed_fn``
    call (None = a single call for the whole batch, the serving default).
    """

    def __init__(self, index, *, max_group_chars: Optional[int] = None):
        self.index = index
        self.max_group_chars = max_group_chars

    # ------------------------------------------------------------------
    # plan
    # ------------------------------------------------------------------
    def plan(self, probed_per_q: Sequence[Sequence[int]]) -> ResolutionPlan:
        ix = self.index
        owner: Dict[int, int] = {}
        for qi, probed in enumerate(probed_per_q):
            for cid in probed:
                owner.setdefault(cid, qi)
        tier: Dict[int, str] = {}
        storage_clusters: List[int] = []
        cached: Dict[int, np.ndarray] = {}
        pending: List[int] = []
        restore: List[int] = []
        for cid in owner:
            cl = ix.clusters[cid]
            if cl.stored:
                if cl.storage_fresh and cid in ix.storage:
                    tier[cid] = TIER_STORAGE
                    storage_clusters.append(cid)
                    continue
                # storage copy vanished out-of-band, or went stale behind a
                # mutation (deferred maintenance hasn't restored it yet):
                # regenerate AND re-persist (same recovery as an
                # execute-time vanish)
                tier[cid] = TIER_REGEN
                pending.append(cid)
                restore.append(cid)
                continue
            hit = ix.cache.access(cid)   # Alg. 2: one bump + decay per batch
            if hit is not None:
                tier[cid] = TIER_CACHE
                cached[cid] = hit
                continue
            tier[cid] = TIER_REGEN
            pending.append(cid)
        return ResolutionPlan(
            probed_per_q=[list(p) for p in probed_per_q],
            owner=owner, tier=tier, storage_clusters=storage_clusters,
            cached=cached, regen_groups=self._coalesce(pending),
            restore=restore,
            generations={cid: ix.clusters[cid].generation for cid in owner},
            content_generations={cid: ix.clusters[cid].content_generation
                                 for cid in owner})

    def _coalesce(self, pending: List[int]) -> List[List[int]]:
        if not pending:
            return []
        if self.max_group_chars is None:
            return [list(pending)]
        groups: List[List[int]] = []
        cur: List[int] = []
        chars = 0
        for cid in pending:
            c = self.index.clusters[cid].char_count
            if cur and chars + c > self.max_group_chars:
                groups.append(cur)
                cur, chars = [], 0
            cur.append(cid)
            chars += c
        if cur:
            groups.append(cur)
        return groups

    # ------------------------------------------------------------------
    # prefetch (serving engine hook)
    # ------------------------------------------------------------------
    def prefetch(self, plan: ResolutionPlan) -> ResolutionPlan:
        """Issue the plan's storage loads ahead of execution.  The RAW
        payloads ride along on the plan so execute() doesn't re-read them;
        the engine overlaps their modeled I/O seconds with prefill."""
        if plan.storage_clusters and plan.prefetched is None:
            outcomes: List[IOOutcome] = []
            loaded = self.index.storage.get_many_raw(plan.storage_clusters,
                                                     outcomes=outcomes)
            plan.prefetched = {cid: payload for cid, payload
                               in zip(plan.storage_clusters, loaded)
                               if payload is not None}
            plan.io_outcomes = {o.key: o for o in outcomes}
        return plan

    # ------------------------------------------------------------------
    # execute
    # ------------------------------------------------------------------
    def execute(self, plan: ResolutionPlan, lats: List[LatencyBreakdown],
                missed: List[bool], *, raw: bool = False) -> Dict[int, object]:
        """Materialize ``plan``; returns cluster id -> f32 (n, d) matrix,
        or cluster id -> :class:`SlabPayload` when ``raw=True`` (the slab
        scoring mode).

        Side effects mirror the single-query path: owners are charged tier
        costs, regenerated clusters refresh ``gen_latency_est`` and enter
        the cache under the current Alg. 3 threshold, and ``missed[qi]`` is
        set for every query that owns a regenerated cluster.
        """
        ix = self.index
        resolved: Dict[int, object] = {}
        regen_groups = [list(g) for g in plan.regen_groups]
        fallback: List[int] = []      # stale / vanished since plan time
        deadlines = plan.deadlines
        policy = plan.policy if deadlines is not None else None
        if policy is None and deadlines is not None:
            policy = DegradationPolicy()

        def _budget_left(qi: int) -> Optional[float]:
            """Remaining deadline budget of one query, against the edge
            seconds its LatencyBreakdown has accrued SO FAR this batch
            (retries and stalls charged earlier in this execute included)."""
            if deadlines is None or deadlines[qi] is None:
                return None
            return deadlines[qi] - lats[qi].retrieval_s

        if plan.storage_clusters:
            if plan.prefetched is not None:
                loaded = [plan.prefetched.get(c)
                          for c in plan.storage_clusters]
                outcomes = plan.io_outcomes or {}
            else:
                olist: List[IOOutcome] = []
                loaded = ix.storage.get_many_raw(plan.storage_clusters,
                                                 outcomes=olist)
                outcomes = {o.key: o for o in olist}
            for cid, payload in zip(plan.storage_clusters, loaded):
                # fault charges (retries / stalls / backoff) land on the
                # owner whether or not the read ultimately succeeded
                self._charge_io(lats[plan.owner[cid]], outcomes.get(cid))
                # Staleness guard: a prefetched payload is only scoreable if
                # the cluster's generation never moved after the plan; an
                # execute-time load only if the storage copy reflects the
                # CURRENT generation (a sync restore may have refreshed it
                # after the plan went stale).  Either failure — or a deleted
                # key, or a row-count mismatch (defense in depth) — falls
                # back to regeneration instead of crashing or scoring stale
                # ids.
                cl = ix.clusters[cid]
                fresh = (plan.fresh(cid, cl) if plan.prefetched is not None
                         else cl.storage_fresh)
                if (payload is None or not fresh
                        or ix.storage.payload_rows(payload) != cl.size):
                    fallback.append(cid)
                    continue
                try:
                    nbytes = ix.storage.stored_bytes(cid)
                except KeyError:
                    fallback.append(cid)
                    continue
                lat = lats[plan.owner[cid]]
                lat.l2_storage_load_s += ix.cost.storage_load_latency(nbytes)
                lat.n_storage_loads += 1
                resolved[cid] = self._resolve_payload(payload, lat, raw)
        for cid, embs in plan.cached.items():
            # generation guard (same-size mutations included) + row-count
            # defense: a cluster mutated since plan time would misalign the
            # scoring id map
            cl = ix.clusters[cid]
            if not plan.fresh(cid, cl) or len(embs) != cl.size:
                qi = plan.owner[cid]
                budget = _budget_left(qi)
                if (policy is not None and policy.serve_stale
                        and budget is not None
                        and cl.gen_latency_est > budget
                        and len(embs) == cl.size):
                    # ladder rung 3: the deadline cannot afford the
                    # regeneration, and the stale payload still row-aligns
                    # with the cluster (same-size mutation) — score it,
                    # flagged, and evict it so the next unpressured batch
                    # regenerates a fresh copy
                    lat = lats[qi]
                    lat.l2_cache_hit_s += ix.cost.mem_load_latency(
                        embs.nbytes, resident_bytes=ix.memory_bytes())
                    lat.n_cache_hits += 1
                    lat.stale_served += 1
                    ix.cache.invalidate(cid)
                    resolved[cid] = (SlabPayload("fp32", embs) if raw
                                     else embs)
                    continue
                ix.cache.invalidate(cid)   # don't let the stale entry recur
                fallback.append(cid)
                continue
            lat = lats[plan.owner[cid]]
            lat.l2_cache_hit_s += ix.cost.mem_load_latency(
                embs.nbytes, resident_bytes=ix.memory_bytes())
            lat.n_cache_hits += 1
            resolved[cid] = SlabPayload("fp32", embs) if raw else embs
        if fallback:
            regen_groups.append(fallback)
        heal = set(fallback) | set(plan.restore)
        # ladder rung 2: an owner whose queued regenerations cannot fit its
        # remaining budget sheds the MOST EXPENSIVE ones first; shed
        # clusters fall to _resolve_degraded (stale stored copy when one
        # still row-aligns, else zero rows) and never regenerate
        shed: set = set()
        if policy is not None and policy.shed_regen:
            per_owner: Dict[int, List[int]] = {}
            for group in regen_groups:
                for cid in group:
                    cl = ix.clusters[cid]
                    if cl.active and cl.size > 0:
                        per_owner.setdefault(plan.owner[cid], []).append(cid)
            for qi, cids in per_owner.items():
                budget = _budget_left(qi)
                if budget is None:
                    continue
                total = sum(ix.clusters[c].gen_latency_est for c in cids)
                for c in sorted(cids,
                                key=lambda c: -ix.clusters[c].gen_latency_est):
                    if total <= budget:
                        break
                    shed.add(c)
                    total -= ix.clusters[c].gen_latency_est
        for group in regen_groups:
            # clusters merged away (or emptied) since plan time have no
            # text to regenerate: they resolve to zero rows and drop out
            # of scoring
            dead = [c for c in group if not (ix.clusters[c].active
                                             and ix.clusters[c].size > 0)]
            for c in dead:
                empty = np.zeros((0, ix.dim), np.float32)
                resolved[c] = SlabPayload("fp32", empty) if raw else empty
            group = [c for c in group if c not in dead]
            if shed:
                for cid in group:
                    if cid in shed:
                        self._resolve_degraded(cid, plan, lats, resolved, raw)
                group = [c for c in group if c not in shed]
            if not group:
                continue
            for cid, sub, chars in self._regen_group(group):
                cl = ix.clusters[cid]
                if (cl.stored and cid in heal
                        and (not cl.storage_fresh or cid not in ix.storage)):
                    # self-heal the vanished/stale storage copy so later
                    # batches load instead of regenerating forever; a
                    # budget-refused put (returns 0) leaves the cluster on
                    # the regen path instead
                    if ix.storage.put(cid, sub.copy()) > 0:
                        cl.stored_generation = cl.generation
                    else:
                        cl.stored = False
                        cl.stored_generation = -1
                    # the heal changed durable-relevant state: commit it as
                    # one WAL record, fsync charged to the owning query
                    ix._dirty.add(cid)
                    lats[plan.owner[cid]].wal_fsync_s += \
                        ix._wal_commit("self_heal")
                gen_s = ix.cost.embed_latency(chars)
                qi = plan.owner[cid]
                lats[qi].l2_generate_s += gen_s
                lats[qi].n_generated += 1
                lats[qi].chars_embedded += chars
                missed[qi] = True
                cl.gen_latency_est = gen_s
                if not cl.stored:
                    # copy: a view into the group's matrix would pin the
                    # whole group in the cache and break its byte accounting.
                    # (Stored clusters skip the cache: plan() always serves
                    # fresh stored clusters from the storage tier, so a
                    # cached copy would be dead weight.)
                    ix.cache.insert(
                        cid, sub.copy(), gen_s,
                        min_latency_threshold=ix.threshold.threshold)
                resolved[cid] = SlabPayload("fp32", sub) if raw else sub
        return resolved

    def _resolve_payload(self, payload: Dict[str, np.ndarray],
                         lat: LatencyBreakdown, raw: bool):
        """A loaded storage payload as the caller wants it: undecoded
        (``raw``, for the slab) or decoded to f32, with the decode charged
        as compute (``l2_dequant_s``) for a quantized codec."""
        storage = self.index.storage
        if raw:
            return SlabPayload.from_raw(payload, codebook=storage.pq)
        embs = storage.decode(payload)
        if storage.codec != "fp32":
            lat.l2_dequant_s += self.index.cost.dequant_latency(embs.size)
        return embs

    @staticmethod
    def _charge_io(lat: LatencyBreakdown,
                   outcome: Optional[IOOutcome]) -> None:
        """Land one read's fault costs (injected stall seconds, modeled
        retry backoff, retry count) on the owning query."""
        if outcome is None:
            return
        lat.l2_stall_s += outcome.stall_s
        lat.l2_retry_backoff_s += outcome.backoff_s
        lat.retries += outcome.retries

    def _resolve_degraded(self, cid: int, plan: ResolutionPlan,
                          lats: List[LatencyBreakdown],
                          resolved: Dict[int, object], raw: bool) -> None:
        """Resolve one rung-2-shed cluster without regenerating: serve the
        STALE stored copy flagged stale when one exists and still
        row-aligns with the cluster (rung 3 via storage), else skip the
        cluster entirely — zero rows, counted in ``degraded_clusters``."""
        ix = self.index
        cl = ix.clusters[cid]
        lat = lats[plan.owner[cid]]
        policy = plan.policy or DegradationPolicy()
        if policy.serve_stale and cl.stored and cid in ix.storage:
            outcomes: List[IOOutcome] = []
            payload = ix.storage.get_many_raw([cid], outcomes=outcomes)[0]
            self._charge_io(lat, outcomes[0])
            if (payload is not None
                    and ix.storage.payload_rows(payload) == cl.size):
                try:
                    nbytes = ix.storage.stored_bytes(cid)
                except KeyError:
                    nbytes = sum(a.nbytes for a in payload.values())
                lat.l2_storage_load_s += ix.cost.storage_load_latency(nbytes)
                lat.n_storage_loads += 1
                lat.stale_served += 1
                resolved[cid] = self._resolve_payload(payload, lat, raw)
                return
        lat.degraded_clusters += 1
        empty = np.zeros((0, ix.dim), np.float32)
        resolved[cid] = SlabPayload("fp32", empty) if raw else empty

    # ------------------------------------------------------------------
    # packed-slab execution (the search_batch scoring engine)
    # ------------------------------------------------------------------
    def stale_cids(self, plan: ResolutionPlan) -> List[int]:
        """Planned clusters whose MEMBERSHIP/CONTENT moved since plan time
        — the staged pipeline's S3 entry check: payloads fetched at S2 for
        these clusters may no longer row-align, so the batch re-enters S1
        (re-plan + re-fetch) instead of packing a slab that would trip the
        pack-time defenses.  Storage-tier flips (a bubble-drain restore or
        drop bumping ``generation`` alone) deliberately do NOT count:
        payloads already in hand don't care where later fetches would come
        from, and counting them would make every in-flight plan stale the
        moment maintenance runs."""
        return [cid for cid in plan.owner
                if not plan.content_fresh(cid, self.index.clusters[cid])]

    def pack_slab(self, plan: ResolutionPlan,
                  payloads: Dict[int, object],
                  lats: List[LatencyBreakdown]) -> SlabLayout:
        """Pack resolved RAW payloads into a :class:`SlabLayout`: every
        cluster lands exactly once in the segment of its storage
        representation; the per-cluster payloads become views into the
        slab (:meth:`SlabLayout.view`).  Each cluster's owner is charged
        the pack copy (``l2_slab_pack_s``) and, for fp16 / int8 payloads,
        the in-kernel decode (``l2_fused_dequant_s``) once per slab, not
        once per probing query.  PQ payloads are charged the in-kernel code
        gather (``l2_pq_gather_s``, rows × m lookups) instead: no decode
        ever happens.
        """
        ix = self.index
        slab = SlabLayout.pack(ix.dim, list(plan.owner), payloads,
                               lambda cid: ix.clusters[cid].ids)
        for cid, owner_qi in plan.owner.items():
            p = payloads[cid]
            if p.rows == 0:
                continue
            lat = lats[owner_qi]
            lat.l2_slab_pack_s += ix.cost.slab_pack_latency(p.nbytes)
            if p.kind == "pq":
                lat.l2_pq_gather_s += ix.cost.pq_gather_latency(p.emb.size)
            elif p.kind != "fp32":
                lat.l2_fused_dequant_s += ix.cost.fused_dequant_latency(
                    p.emb.size)
        return slab

    def execute_slab(self, plan: ResolutionPlan,
                     lats: List[LatencyBreakdown],
                     missed: List[bool]) -> SlabLayout:
        """RAW-mode :meth:`execute` + :meth:`pack_slab` in one step (the
        staged path runs them as separate S2/S3 stages)."""
        payloads = self.execute(plan, lats, missed, raw=True)
        return self.pack_slab(plan, payloads, lats)

    # ------------------------------------------------------------------
    # regeneration (shared with the maintenance paths)
    # ------------------------------------------------------------------
    def _regen_group(self, cids: Sequence[int]):
        """ONE ``embed_fn`` call over the group's concatenated texts; yields
        (cid, embeddings view, char count) per cluster."""
        ix = self.index
        texts_per = [ix.get_chunks(ix.clusters[c].ids.tolist())
                     for c in cids]
        flat = [txt for ts in texts_per for txt in ts]
        embs_all = np.ascontiguousarray(ix.embed_fn(flat), np.float32)
        off = 0
        for cid, ts in zip(cids, texts_per):
            sub = embs_all[off:off + len(ts)]
            off += len(ts)
            yield cid, sub, sum(len(txt) for txt in ts)

    def regenerate(self, cids: Sequence[int]) -> List[np.ndarray]:
        """Coalesced regeneration outside a search (restore / split paths).
        No latency attribution, no cache interaction."""
        return [sub.copy() for _, sub, _ in self._regen_group(list(cids))]
