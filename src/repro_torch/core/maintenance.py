"""Generation-stamped online-maintenance subsystem (§5.4 made correct).

Two pieces make index mutation safe to interleave with (pre-planned)
retrieval:

GENERATION STAMPS.  Every :class:`~repro_torch.core.edgerag.EdgeCluster` carries a
monotonically increasing ``generation``, bumped by *any* mutation — insert,
remove, split, merge, restore, stored-copy drop.  A
:class:`~repro_torch.core.resolver.ResolutionPlan` snapshots the ``(cid,
generation)`` pair of every planned cluster, and
:meth:`~repro_torch.core.resolver.ClusterResolver.execute` compares snapshots
against the live clusters: any mismatch means the payload the plan is about
to score (a prefetched storage blob, a plan-time cache hit) may describe a
membership that no longer exists, so the cluster falls back to fresh
regeneration.  Unlike the older ``len(embs) != size`` guard (kept only as
defense in depth), generations catch SAME-SIZE mutations — remove-one /
insert-one, split reassignment — that leave the row count intact but move
chunks around.  Clusters additionally track ``stored_generation``, the
generation their storage copy reflects; a stored cluster whose stamps
disagree is served by regeneration (and re-persisted) instead of loading the
stale blob.

DEFERRED MAINTENANCE.  The seed executed split / merge / restore
synchronously inside ``insert`` / ``remove`` ("async in the paper;
synchronous here").  :class:`MaintenanceScheduler` turns that work into a
queue of :class:`MaintenanceOp`\\ s: mutations enqueue and return fast, and
the queue drains *between* serving steps under a per-step edge-cost budget
(costs modeled through :class:`~repro_torch.core.costs.EdgeCostModel`).  Every op
is RE-VALIDATED against the cluster's current state at drain time — a queued
split whose cluster has since shrunk is skipped, a queued restore whose
cluster became cheap turns into a stored-copy drop — so the queue converges
to the Alg. 1 invariant (stored ⇔ regeneration cost over SLO) regardless of
how mutations interleaved.  Deferral never affects correctness: an
un-restored cluster resolves through regeneration, an un-split cluster is
merely oversized, an un-merged cluster merely small.  ``drain(None)`` (no
budget) runs the queue to quiescence, after which the synchronous-mode
invariants hold exactly.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

OP_RESTORE = "restore"        # (re)generate + persist the storage copy
OP_DROP_STORE = "drop_store"  # cluster became cheap: delete the stored copy
OP_SPLIT = "split"            # one k=2 split level (follow-ups re-enqueue)
OP_MERGE = "merge"            # fold an undersized cluster into its neighbor
OP_CHECKPOINT = "checkpoint"  # durability snapshot + WAL compaction
CHECKPOINT_CID = -1           # checkpoints are whole-index, not per-cluster


@dataclasses.dataclass
class MaintenanceOp:
    kind: str
    cid: int
    generation: int     # cluster generation when enqueued (telemetry)


@dataclasses.dataclass
class MaintenanceReport:
    """What one :meth:`MaintenanceScheduler.drain` call did."""
    executed: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    skipped: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    failed: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    # ^ ops that raised this drain (re-queued, or quarantined on the Nth)
    quarantined: List[Tuple[str, int]] = \
        dataclasses.field(default_factory=list)
    edge_s: float = 0.0          # modeled edge seconds spent this drain
    remaining: int = 0           # ops still queued when the budget ran out

    @property
    def n_executed(self) -> int:
        return len(self.executed)


class MaintenanceScheduler:
    """Deferred split / merge / restore queue for an ``EdgeRAGIndex``.

    ``budget_s_per_step`` is the default edge-second budget of one
    :meth:`drain` call (None = run to quiescence).  A drain always executes
    at least one runnable op so the queue cannot stall behind a single op
    larger than the budget.  The queue is keyed by ``(kind, cid)``:
    re-enqueueing an op refreshes its stamp instead of duplicating it.
    """

    def __init__(self, index, budget_s_per_step: Optional[float] = None,
                 max_op_failures: int = 3):
        self.index = index
        self.budget_s_per_step = budget_s_per_step
        self.max_op_failures = max_op_failures
        self._queue: "OrderedDict[Tuple[str, int], MaintenanceOp]" = \
            OrderedDict()
        self._failures: Dict[Tuple[str, int], int] = {}
        self.quarantined: "OrderedDict[Tuple[str, int], str]" = OrderedDict()
        # ^ (kind, cid) -> last error; these ops stopped retrying
        self.total_edge_s = 0.0
        self.n_executed = 0
        self.n_skipped = 0
        self.n_failures = 0          # individual op failures (raises) seen

    # ------------------------------------------------------------------
    # queue
    # ------------------------------------------------------------------
    def enqueue(self, kind: str, cid: int):
        key = (kind, cid)
        # a fresh enqueue is new evidence the op is wanted: lift any
        # quarantine and give it a clean failure budget
        self.quarantined.pop(key, None)
        self._failures.pop(key, None)
        self._queue.pop(key, None)      # refresh: move to the back
        self._queue[key] = MaintenanceOp(
            kind, cid,
            0 if cid < 0 else self.index.clusters[cid].generation)

    def clear(self):
        """Drop every queued op (index rebuilds)."""
        self._queue.clear()
        self._failures.clear()
        self.quarantined.clear()

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending(self) -> List[MaintenanceOp]:
        return list(self._queue.values())

    # ------------------------------------------------------------------
    # cost model
    # ------------------------------------------------------------------
    def estimate_cost_s(self, kind: str, cid: int) -> float:
        """Modeled edge seconds of one op.  Regeneration dominates restore /
        split / merge; storage writes are charged at the sequential-read
        bandwidth (the cost model has no separate write channel); a split
        adds ~10 Lloyd iterations of 2-means over the cluster."""
        ix = self.index
        if kind == OP_CHECKPOINT:
            return ix.durability.checkpoint_cost_s(ix)
        cl = ix.clusters[cid]
        cost = ix.cost
        put_s = cost.storage_load_latency(cl.size * ix.dim * 4)
        if kind == OP_DROP_STORE:
            return cost.storage_seek_s
        if kind == OP_RESTORE:
            return cost.embed_latency(cl.char_count) + put_s
        if kind == OP_SPLIT:
            kmeans_s = 10 * 2 * cost.search_latency(cl.size, ix.dim)
            return cost.embed_latency(cl.char_count) + kmeans_s + put_s
        if kind == OP_MERGE:
            # when the merge triggers a restore it regenerates the MERGED
            # text — the surviving neighbor's chars dominate, so bill them
            base = cost.search_latency(ix.nlist, ix.dim)
            tgt = ix._merge_target(cid)
            if tgt is None:
                return base
            other = ix.clusters[tgt]
            merged_chars = cl.char_count + other.char_count
            if other.stored or (ix.store_heavy
                                and cost.embed_latency(merged_chars)
                                > ix.slo_s):
                base += (cost.embed_latency(merged_chars)
                         + cost.storage_load_latency(
                             (cl.size + other.size) * ix.dim * 4))
            return base
        raise ValueError(f"unknown maintenance op kind: {kind}")

    # ------------------------------------------------------------------
    # drain
    # ------------------------------------------------------------------
    def _revalidate(self, op: MaintenanceOp) -> Optional[str]:
        """The op kind the cluster's CURRENT state calls for (None = the op
        is no longer needed).  restore / drop_store reconcile to whichever
        direction Alg. 1 wants now, whatever was queued — and so does a
        split whose cluster shrank back under the bound (a split supersedes
        the restore at enqueue time, so the storage reconciliation it
        absorbed must not vanish with it)."""
        ix = self.index
        if op.kind == OP_CHECKPOINT:
            # still wanted iff a durability handle is attached and records
            # accumulated since the last snapshot (another drain may have
            # checkpointed already — then this one is free to skip)
            if (ix.durability is not None
                    and ix.durability.records_since_snapshot > 0):
                return OP_CHECKPOINT
            return None
        cl = ix.clusters[op.cid]
        if op.kind == OP_MERGE:
            if (cl.active and 0 < cl.size < ix.merge_min_size
                    and ix.nlist >= 2):
                return OP_MERGE
            return None
        oversized = (cl.active and cl.size >= 2
                     and cl.char_count > ix.split_max_chars)
        if op.kind == OP_SPLIT and oversized:
            return OP_SPLIT
        # restore / drop_store — or a split no longer needed: reconcile
        # the storage copy with Alg. 1
        if oversized:
            # an oversized cluster always has a split queued (any mutation
            # that saw it oversized enqueued one), and the split
            # re-persists its parts itself — restoring first would be
            # thrown away
            return None
        want_stored = (cl.active and cl.size > 0 and ix.store_heavy
                       and cl.gen_latency_est > ix.slo_s)
        if want_stored:
            fresh = (cl.stored and cl.stored_generation == cl.generation
                     and op.cid in ix.storage)
            return None if fresh else OP_RESTORE
        return OP_DROP_STORE if cl.stored else None

    def _apply(self, kind: str, cid: int) -> float:
        """Run one op; returns EXTRA edge seconds beyond the estimate —
        the durability WAL fsync the op commits (zero with no handle)."""
        ix = self.index
        if kind == OP_CHECKPOINT:
            return ix.durability.checkpoint(ix) \
                - self.estimate_cost_s(kind, cid)
        if kind == OP_RESTORE:
            ix._restore_cluster(cid)
        elif kind == OP_DROP_STORE:
            ix._drop_stored(cid)
        elif kind == OP_SPLIT:
            produced = ix._split_once(cid)
            if not produced:
                # degenerate split: still reconcile the storage copy the
                # split superseded at enqueue time
                ix._reconcile_storage(cid)
            for slot in produced:
                cl = ix.clusters[slot]
                if cl.char_count > ix.split_max_chars and cl.size >= 2:
                    self.enqueue(OP_SPLIT, slot)    # budgeted follow-up
        elif kind == OP_MERGE:
            ix._merge_cluster(cid)
        # commit the op's dirty set as one WAL record (no-op without a
        # durability handle; getattr keeps bare index stubs drainable)
        commit = getattr(ix, "_wal_commit", None)
        return 0.0 if commit is None else commit(kind)

    def drain(self, budget_s: Optional[float] = None,
              strict: bool = False,
              max_ops: Optional[int] = None) -> MaintenanceReport:
        """Run queued ops until the queue is empty or the budget is spent.

        ``budget_s`` overrides ``budget_s_per_step``; None on both means run
        to quiescence.  Skipped (re-validated-away) ops are free.

        By default a drain always executes at least one runnable op, so a
        single op larger than the budget cannot stall the queue forever.
        ``strict=True`` inverts that: no op whose estimate overruns the
        remaining budget runs (FIFO order — the drain stops at the first
        unaffordable op).  Strict drains model maintenance that must fit an
        idle window exactly (e.g. the gap before the next known arrival);
        oversized ops wait for a deeper idle period or an unbudgeted drain.

        ``max_ops`` caps EXECUTED ops this call (skips are still free):
        :class:`FairShareMaintenance` steps tenants one op at a time with
        ``max_ops=1``.
        """
        if budget_s is None:
            budget_s = self.budget_s_per_step
        report = MaintenanceReport()
        failed_this_drain: set = set()
        while self._queue:
            if max_ops is not None and len(report.executed) >= max_ops:
                break
            key, op = next(iter(self._queue.items()))
            if key in failed_this_drain:
                break   # only ops that already raised this drain remain
            try:
                kind = self._revalidate(op)
                est = (0.0 if kind is None
                       else self.estimate_cost_s(kind, op.cid))
            except Exception as e:      # noqa: BLE001 — isolate the op
                self._record_failure(key, op, e, report, failed_this_drain)
                continue
            if kind is None:
                del self._queue[key]
                report.skipped.append((op.kind, op.cid))
                self.n_skipped += 1
                continue
            if (budget_s is not None and (strict or report.executed)
                    and report.edge_s + est > budget_s):
                break                      # budget spent (≥1 op ran unless strict)
            del self._queue[key]
            try:
                extra_s = self._apply(kind, op.cid)
            except Exception as e:      # noqa: BLE001 — isolate the op
                self._record_failure(key, op, e, report, failed_this_drain)
                continue
            report.executed.append((kind, op.cid))
            report.edge_s += est + extra_s
            self.n_executed += 1
        report.remaining = len(self._queue)
        self.total_edge_s += report.edge_s
        return report

    def _record_failure(self, key: Tuple[str, int], op: MaintenanceOp,
                        err: Exception, report: MaintenanceReport,
                        failed_this_drain: set):
        """One op raised: the queue must keep draining.  The op goes to the
        BACK for another try on a later drain, and after
        ``max_op_failures`` raises it is quarantined (kept out of the
        queue, last error recorded) — a poison op can wedge neither this
        drain nor the scheduler.  A fresh :meth:`enqueue` of the same
        (kind, cid) lifts the quarantine."""
        self.n_failures += 1
        report.failed.append(key)
        failed_this_drain.add(key)
        self._queue.pop(key, None)
        n = self._failures.get(key, 0) + 1
        self._failures[key] = n
        if n >= self.max_op_failures:
            self.quarantined[key] = f"{type(err).__name__}: {err}"
            self._failures.pop(key, None)
            report.quarantined.append(key)
        else:
            self._queue[key] = op

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return {
            "pending": len(self._queue),
            "executed": self.n_executed,
            "skipped": self.n_skipped,
            "failures": self.n_failures,
            "quarantined": len(self.quarantined),
            "total_edge_s": self.total_edge_s,
        }


class FairShareMaintenance:
    """Round-robin multiplexer over per-tenant :class:`MaintenanceScheduler`s.

    The shared device has ONE maintenance budget per idle window; with a
    plain FIFO a churn-heavy tenant would starve everyone else's restores.
    This drains tenants in round-robin order, one executed op per turn
    (``max_ops=1``), with the rotation cursor persisting ACROSS drains so a
    window that only fits one op still rotates fairly over time.  The
    effective queue is keyed ``(tenant, kind, cid)``: each tenant's
    scheduler keeps its own ``(kind, cid)`` keys and this class supplies
    the tenant axis — report entries come back as
    ``(kind, (tenant, cid))``.

    Interface-compatible with a single :class:`MaintenanceScheduler` where
    the serving layer is concerned (``__len__`` / ``drain`` / ``clear`` /
    ``pending`` / ``total_edge_s`` / ``stats``), so
    :class:`~repro_torch.serving.engine.RAGEngine` and
    :class:`~repro_torch.serving.pipeline.StagedPipeline` drain a router's
    maintenance exactly as they drain an index's.
    """

    def __init__(self):
        self._scheds: "OrderedDict[str, MaintenanceScheduler]" = OrderedDict()
        self._rr = 0                    # rotation cursor, persists
        self.total_edge_s = 0.0
        self.n_executed = 0
        self.per_tenant_edge_s: Dict[str, float] = {}

    def register(self, tenant: str, sched: MaintenanceScheduler):
        assert tenant not in self._scheds, f"tenant {tenant!r} registered"
        self._scheds[tenant] = sched
        self.per_tenant_edge_s.setdefault(tenant, 0.0)

    def __len__(self) -> int:
        return sum(len(s) for s in self._scheds.values())

    @property
    def pending(self) -> List[Tuple[str, MaintenanceOp]]:
        return [(t, op) for t, s in self._scheds.items()
                for op in s.pending]

    @property
    def quarantined(self) -> Dict[Tuple[str, str, int], str]:
        return {(t, k, c): err for t, s in self._scheds.items()
                for (k, c), err in s.quarantined.items()}

    def clear(self):
        for s in self._scheds.values():
            s.clear()

    def drain(self, budget_s: Optional[float] = None,
              strict: bool = False) -> MaintenanceReport:
        """One fair-share pass: rotate tenants, one executed op per turn,
        until every queue is empty / unaffordable or the budget is spent.
        Non-strict drains keep the single-scheduler guarantee — the FIRST
        op may overrun the budget so one oversized op cannot stall the
        whole substrate — after which the budget binds strictly."""
        report = MaintenanceReport()
        scheds = list(self._scheds.items())
        if not scheds:
            return report
        n = len(scheds)
        stalled = 0             # consecutive turns with no queue progress
        while stalled < n:
            # budget check precedes taking the turn: a tenant skipped only
            # because the budget ran out keeps its slot for the next drain
            remaining = None if budget_s is None else budget_s - report.edge_s
            if (remaining is not None and remaining <= 0
                    and (strict or report.executed)):
                break
            tenant, sched = scheds[self._rr % n]
            self._rr += 1
            if not len(sched):
                stalled += 1
                continue
            rep = sched.drain(remaining,
                              strict=strict or bool(report.executed),
                              max_ops=1)
            report.executed += [(k, (tenant, c)) for k, c in rep.executed]
            report.skipped += [(k, (tenant, c)) for k, c in rep.skipped]
            report.failed += [(k, (tenant, c)) for k, c in rep.failed]
            report.quarantined += [(k, (tenant, c))
                                   for k, c in rep.quarantined]
            report.edge_s += rep.edge_s
            self.per_tenant_edge_s[tenant] = (
                self.per_tenant_edge_s.get(tenant, 0.0) + rep.edge_s)
            stalled = 0 if (rep.executed or rep.skipped) else stalled + 1
        report.remaining = len(self)
        self.total_edge_s += report.edge_s
        self.n_executed += report.n_executed
        return report

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {t: s.stats() for t, s in self._scheds.items()}
        for t in out:
            out[t]["fair_share_edge_s"] = self.per_tenant_edge_s.get(t, 0.0)
        return out
