"""Staged serving pipeline: hide retrieval + maintenance under decode.

Port of ``repro.serving.pipeline``.  It touches no tensor: the engine's
index and generator (or batcher) carry the device, so the stages' real
work runs on the card unless they were made with ``device="cpu"``.  A
batch may carry one tenant id a query (``PipelineBatch.tenants``) when the
engine fronts a :class:`~repro_torch.core.tenant.TenantRouter`: its S1
probes each tenant present and its S3 scores them all in one launch.

The sequential ``RAGEngine.answer_batch`` runs retrieve-then-decode strictly
in order, so the accelerator sits idle during storage I/O and the storage
path sits idle during decode.  On one resource-constrained device that
serialization is where online-RAG throughput goes to die (RAGDoll, arXiv
2504.15302; MobileRAG, arXiv 2507.01079): retrieval and token generation
use DIFFERENT resources and can overlap almost entirely.

:class:`StagedPipeline` runs the engine's four stages as independent
resources on the shared modeled clock (``EdgeCostModel`` seconds):

    S1 probe/plan      fused centroid top-k + ClusterResolver plan
    S2 fetch/regen     raw storage loads + coalesced embed regeneration
                       (fault retries / stalls / degradation rungs 2-3)
    S3 pack + score    slab pack → multi-query fused top-k + prompts
    S4 prefill/decode  ContinuousBatcher ticks (or per-query generator)

While batch N occupies S4, batches N+1 / N+2 advance through S1-S3.  The
executor is a discrete-event loop: each stage resource has a ``free_at``
clock, each in-flight batch a ready time; the earliest-firing (stage,
batch) pair executes its REAL work at its modeled fire time, so anything
that happens "during a bubble" (maintenance, another batch's regen) is
physically ordered exactly as the modeled clock says.  Ties fire the later
stage first, draining downstream work ahead of admitting more upstream.
The work itself runs on one host thread in that order: nothing overlaps
in real time, so a pipelined run's wall time is that of its batches
served one after another.

MAINTENANCE IN BUBBLES: when S2 / S3 sat idle before firing, the gap is a
bubble — ``MaintenanceScheduler.drain(gap, strict=True)`` fills it with
deferred split / merge / restore work instead of the sequential path's
post-decode drain.  Gaps before the first S4 fire are ramp-up, not
bubbles — there is no decode to hide under yet, so drains wait until the
decode stage is occupied.  The pipeline OWNS draining (construct the
engine with ``maintenance_owner="external"``); a final drain after the
last decode finishes whatever the bubbles didn't fit.

STALENESS: bubble maintenance (and any concurrent mutation) can move a
planned cluster's generation while its batch sits between stages.  A
mutation in the S1→S2 window is already safe — ``ClusterResolver.execute``
regenerates stamped-stale clusters over their current membership.  A
CONTENT move (insert / update / remove / split / merge) in the S2→S3
window is caught at S3 fire time by ``ClusterResolver.stale_cids``: the
batch RE-ENTERS S1 (fresh plan + fetch, counted in
``PipelineTrace.replans``) instead of packing payloads that no longer
row-align.  Storage-tier flips (a bubble-drain restore / drop) bump
``generation`` but not ``content_generation`` and do NOT trigger a replan —
payloads already fetched stay row-aligned and value-identical, and treating
tier flips as staleness would re-plan every in-flight batch each time
maintenance ran.  While a replanned batch is in flight, bubble-filling is
suppressed so it cannot be re-staled — replans converge.

DEADLINES THROUGH QUEUES: a batch's effective TTFT deadline is set when S1
fires, as ``slo - queue_wait`` — the degradation ladder budgets against the
time the request actually has LEFT, not the time it had at submission.
Additional wait in the S2 queue shrinks the plan's remaining retrieval
budgets the same way (``RAGEngine.stage_fetch(extra_wait_s=...)``).

Results equal the sequential path's: the same stage functions run with
the same inputs, only WHEN they run moves.  Payloads roundtrip storage
exactly, regeneration is deterministic, and the generation stamps force
regen over current membership whenever timing differences change cache /
storage state — so ids and scores cannot drift, only latency attribution
can.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import DegradationPolicy
from repro_torch.core.maintenance import OP_CHECKPOINT
from repro_torch.serving.engine import BatchJob, RAGEngine, RAGResponse

STAGES = ("s1", "s2", "s3", "s4")
# stages whose idle gaps maintenance may fill: S2 (storage/embed path) and
# S3 (pack/score path) — S1 is tiny and S4 is the resource being hidden
FILL_STAGES = ("s2", "s3")
# floor for a queue-wait-adjusted deadline: an already-blown SLO degrades
# maximally (min_nprobe, all regens shed) instead of going negative
DEADLINE_FLOOR_S = 1e-6


@dataclasses.dataclass
class PipelineBatch:
    """One admission unit: a batch of queries entering the pipeline."""
    queries: List[str]
    query_embs: np.ndarray
    arrival_s: float = 0.0
    slos: Optional[List[Optional[float]]] = None   # per-query TTFT SLOs
    policy: Optional[DegradationPolicy] = None
    requests: Optional[List[object]] = None        # scheduler Requests
    tenants: Optional[List[str]] = None            # per-query tenant ids
    #                                      (engine fronting a TenantRouter)


@dataclasses.dataclass
class StageTrace:
    """Occupancy record of one stage resource across a pipeline run."""
    name: str
    busy_s: float = 0.0            # modeled seconds executing batch work
    n_fired: int = 0               # batch firings (incl. replanned passes)
    maintenance_s: float = 0.0     # bubble seconds filled with drain work
    maintenance_ops: int = 0       # maintenance ops executed in bubbles
    checkpoints: int = 0           # durability OP_CHECKPOINT ops among them
    max_queue_depth: int = 0       # most batches ever waiting on this stage
    intervals: List[Tuple[float, float]] = \
        dataclasses.field(default_factory=list)

    def as_dict(self) -> Dict[str, float]:
        return {"busy_s": self.busy_s, "n_fired": self.n_fired,
                "maintenance_s": self.maintenance_s,
                "maintenance_ops": self.maintenance_ops,
                "checkpoints": self.checkpoints,
                "max_queue_depth": self.max_queue_depth}


def _union(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """Merge possibly-overlapping (start, end) intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _intersect_s(a: List[Tuple[float, float]],
                 b: List[Tuple[float, float]]) -> float:
    """Total overlap between two DISJOINT-SORTED interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclasses.dataclass
class PipelineTrace:
    """What the staged executor did, on the modeled clock — the proof
    object for "retrieval is hidden under decode" (per-stage busy
    intervals, queue depths, bubbles filled, replans)."""
    stages: Dict[str, StageTrace]
    n_batches: int = 0
    n_queries: int = 0
    makespan_s: float = 0.0        # first arrival → last S4 completion
    replans: int = 0               # stale-plan S1 re-entries
    final_drain_s: float = 0.0     # post-run drain of leftover maintenance

    @property
    def retrieval_busy_s(self) -> float:
        """Union time ANY retrieval stage (S1-S3) was executing."""
        ivs = [iv for s in ("s1", "s2", "s3")
               for iv in self.stages[s].intervals]
        return sum(e - s for s, e in _union(ivs))

    @property
    def decode_busy_s(self) -> float:
        return sum(e - s for s, e in _union(self.stages["s4"].intervals))

    @property
    def hidden_retrieval_s(self) -> float:
        """Retrieval-busy time that ran UNDER decode (interval overlap of
        the S1-S3 union with the S4 union)."""
        retr = _union([iv for s in ("s1", "s2", "s3")
                       for iv in self.stages[s].intervals])
        return _intersect_s(retr, _union(self.stages["s4"].intervals))

    @property
    def hidden_retrieval_fraction(self) -> float:
        """Fraction of retrieval time hidden under decode (1.0 = every
        retrieval second overlapped a decode second)."""
        busy = self.retrieval_busy_s
        return 1.0 if busy <= 0.0 else self.hidden_retrieval_s / busy

    @property
    def bubble_fraction(self) -> float:
        """Fraction of retrieval time EXPOSED (not under decode) — the
        complement of ``hidden_retrieval_fraction``."""
        return 1.0 - self.hidden_retrieval_fraction

    @property
    def maintenance_in_bubbles_s(self) -> float:
        return sum(st.maintenance_s for st in self.stages.values())

    def as_dict(self) -> Dict[str, object]:
        return {
            "n_batches": self.n_batches,
            "n_queries": self.n_queries,
            "makespan_s": self.makespan_s,
            "replans": self.replans,
            "final_drain_s": self.final_drain_s,
            "retrieval_busy_s": self.retrieval_busy_s,
            "decode_busy_s": self.decode_busy_s,
            "hidden_retrieval_s": self.hidden_retrieval_s,
            "hidden_retrieval_fraction": self.hidden_retrieval_fraction,
            "bubble_fraction": self.bubble_fraction,
            "maintenance_in_bubbles_s": self.maintenance_in_bubbles_s,
            "stages": {s: st.as_dict() for s, st in self.stages.items()},
        }


@dataclasses.dataclass
class _InFlight:
    """Executor-side state of one batch moving through the stages."""
    batch: PipelineBatch
    job: BatchJob
    stage_idx: int = 0             # next stage to fire (index into STAGES)
    ready_at: float = 0.0          # modeled time the next stage may start
    s4_start: float = 0.0
    finish_at: float = 0.0
    no_fill: bool = False          # replanned: suppress bubble maintenance


class StagedPipeline:
    """Discrete-event executor for the engine's staged serving path.

    ``engine`` should be constructed with ``maintenance_owner="external"``
    when deferred maintenance is in play — the pipeline drains bubbles and
    runs the final drain itself (it never calls ``answer_batch``, so an
    engine-owned post-decode drain simply never happens here, but other
    callers of the same engine would double-drain).

    ``batcher``: a :class:`~repro_torch.serving.batching.ContinuousBatcher`
    that S4 decodes through (``RAGEngine.stage_decode(batcher=)``), else
    the engine's per-query generator.  ``fill_bubbles=False`` disables
    bubble maintenance (the final drain still runs); ``max_replans`` caps
    stale-plan S1 re-entries per batch before the batch proceeds on the
    resolver's regen-over-current-membership fallback (which is correct
    but may do redundant fetch work).
    """

    def __init__(self, engine: RAGEngine, get_chunks, *, batcher=None,
                 fill_bubbles: bool = True, max_replans: int = 2,
                 final_drain: bool = True):
        self.engine = engine
        self.get_chunks = get_chunks
        self.batcher = batcher
        self.fill_bubbles = fill_bubbles
        self.max_replans = max_replans
        self.final_drain = final_drain

    # ------------------------------------------------------------------
    def run(self, batches: Sequence[PipelineBatch]
            ) -> Tuple[List[List[RAGResponse]], PipelineTrace]:
        """Serve ``batches`` through the staged pipeline.  Returns one
        response list per input batch (same order) plus the trace."""
        eng = self.engine
        trace = PipelineTrace(
            stages={s: StageTrace(name=s) for s in STAGES},
            n_batches=len(batches),
            n_queries=sum(len(b.queries) for b in batches))
        if not batches:
            return [], trace
        flights = [
            _InFlight(batch=b,
                      job=eng.make_job(b.queries, b.query_embs,
                                       self.get_chunks,
                                       deadlines=b.slos, policy=b.policy,
                                       tenants=b.tenants),
                      ready_at=b.arrival_s)
            for b in batches]
        stage_free = {s: 0.0 for s in STAGES}
        sched = getattr(eng.index, "maintenance", None)
        responses: List[Optional[List[RAGResponse]]] = [None] * len(batches)
        n_done = 0
        decode_started = False
        t_start = min(b.arrival_s for b in batches)

        while n_done < len(flights):
            # earliest-firing (batch, stage) pair; ties fire the LATER
            # stage first so downstream work drains ahead of admission
            best = None
            for bi, fl in enumerate(flights):
                if fl.stage_idx >= len(STAGES):
                    continue
                stage = STAGES[fl.stage_idx]
                fire = max(fl.ready_at, stage_free[stage])
                key = (fire, -fl.stage_idx, fl.ready_at, bi)
                if best is None or key < best[0]:
                    best = (key, bi, fl, stage, fire)
            _, bi, fl, stage, fire = best
            st = trace.stages[stage]
            # queue depth: batches ready for this stage at fire time
            depth = sum(1 for o in flights
                        if o.stage_idx < len(STAGES)
                        and STAGES[o.stage_idx] == stage
                        and o.ready_at <= fire)
            st.max_queue_depth = max(st.max_queue_depth, depth)
            # bubble-fill: the stage sat idle from free_at to fire — spend
            # the gap on deferred maintenance (strict budget: never
            # overruns into the batch's start).  A gap only counts as a
            # bubble once decode has started: before the first S4 fire
            # there is nothing to hide under, and a drain during ramp-up
            # lands on the critical path (and can stale the very first
            # plan, forcing a replan nothing amortizes).  Also suppressed
            # while any replanned batch is in flight, so replans converge.
            gap = fire - stage_free[stage]
            if (self.fill_bubbles and stage in FILL_STAGES and gap > 0.0
                    and decode_started
                    and sched is not None and len(sched)
                    and not any(o.no_fill for o in flights)):
                rep = sched.drain(gap, strict=True)
                st.maintenance_s += rep.edge_s
                st.maintenance_ops += rep.n_executed
                # durability checkpoints ride the same bubbles; they bump
                # no generation stamp, so in-flight plans never go stale
                # behind one (the S3 replan gate compares
                # content_generation, which a snapshot leaves untouched)
                st.checkpoints += sum(
                    1 for kind, _ in rep.executed if kind == OP_CHECKPOINT)

            if stage == "s1":
                wait = fire - fl.batch.arrival_s
                fl.job.queue_wait_s = wait
                if fl.batch.slos is not None:
                    fl.job.deadlines = [
                        None if slo is None
                        else max(DEADLINE_FLOOR_S, slo - wait)
                        for slo in fl.batch.slos]
                eng.stage_plan(fl.job)
            elif stage == "s2":
                eng.stage_fetch(fl.job,
                                extra_wait_s=max(0.0, fire - fl.ready_at))
            elif stage == "s3":
                stale = eng.index.resolver.stale_cids(fl.job.state.plan)
                if stale and fl.job.replans < self.max_replans:
                    # plan went stale in the S2→S3 window: re-enter S1
                    # (fresh plan + fetch over current membership) rather
                    # than packing payloads that no longer row-align
                    fl.job.replans += 1
                    trace.replans += 1
                    fl.no_fill = True
                    fl.stage_idx = 0
                    fl.ready_at = fire
                    continue
                eng.stage_score(fl.job)
                fl.no_fill = False
            else:  # s4
                fl.s4_start = fire
                decode_started = True
                eng.stage_decode(fl.job, batcher=self.batcher)

            svc = fl.job.stage_edge_s[stage]
            stage_free[stage] = fire + svc
            fl.ready_at = fire + svc
            fl.stage_idx += 1
            st.busy_s += svc
            st.n_fired += 1
            st.intervals.append((fire, fire + svc))
            if fl.stage_idx >= len(STAGES):
                fl.finish_at = fire + svc
                responses[bi] = eng.finalize(fl.job)
                n_done += 1

        trace.makespan_s = max(fl.finish_at for fl in flights) - t_start
        if self.final_drain and sched is not None and len(sched):
            trace.final_drain_s = sched.drain(None).edge_s
        self._fill_request_times(flights)
        return list(responses), trace

    # ------------------------------------------------------------------
    @staticmethod
    def _fill_request_times(flights: List[_InFlight]):
        """Stamp the batches' request objects (when attached; any object
        with ``start_s``, ``finish_s`` and ``degraded`` attributes): start =
        decode-stage entry, finish = first token out — S4 start + this
        query's place in the batch's cumulative prefill (slots prefill in
        admission order)."""
        for fl in flights:
            if fl.batch.requests is None:
                continue
            prefill_cum = 0.0
            for qi, req in enumerate(fl.batch.requests):
                prefill_cum += fl.job.prefill_edge[qi]
                req.start_s = fl.s4_start
                req.finish_s = fl.s4_start + prefill_cum
                req.degraded = bool(
                    fl.job.lats[qi].degraded_clusters
                    or fl.job.lats[qi].stale_served)
