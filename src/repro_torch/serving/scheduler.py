"""Request scheduler: FIFO admission with SLO tracking and batch grouping.

Port of ``repro.serving.scheduler``.  It touches no tensor: ``serve_fn``
(``run``) and the pipeline's engine (``run_pipelined``) carry the device.
``run_pipelined`` hands each batch's tenant tags to the pipeline
(``PipelineBatch.tenants``), so a tagged stream is served by a pipeline
whose engine fronts a :class:`~repro_torch.core.tenant.TenantRouter`.

EdgeRAG is a single-user edge system, so the paper's serving loop is one
query at a time; the scheduler still models arrival queues and SLO misses so
the benchmarks can report tail latencies under load, and groups decode
requests into fixed-size batches.

MULTI-TENANT ADMISSION: when many tenants share the device, a bursty tenant
can queue enough work that everyone else's deadlines blow before service
even starts (the noisy-neighbor problem).  :class:`TokenBucketAdmission`
gives each tenant a refill rate (its fair share of device throughput) and
decides per request at dequeue time: a request whose realized queue wait
already exceeds its SLO is rejected outright (serving it would burn device
time on a guaranteed miss — load-shedding THOSE requests is what protects
everyone else's tail), a request with a token is admitted, and a request
with neither is admitted anyway if the device is idle (the bucket is
work-conserving: fair-share limits only bind under contention) or
rejected/pre-degraded otherwise.  Rejected requests complete immediately
with ``outcome == "rejected"`` and zero service time.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Union


@dataclasses.dataclass(order=True)
class Request:
    arrival_s: float
    rid: int = dataclasses.field(compare=False)
    query: str = dataclasses.field(compare=False, default="")
    query_emb: Optional[object] = dataclasses.field(compare=False,
                                                    default=None)
    query_chars: int = dataclasses.field(compare=False, default=0)
    slo_s: float = dataclasses.field(compare=False, default=1.0)
    tenant: str = dataclasses.field(compare=False, default="")
    # filled on completion
    start_s: float = dataclasses.field(compare=False, default=0.0)
    finish_s: float = dataclasses.field(compare=False, default=0.0)
    degraded: bool = dataclasses.field(compare=False, default=False)
    # ^ served, but the degradation ladder shed work to make the deadline
    pre_degraded: bool = dataclasses.field(compare=False, default=False)
    # ^ admission flagged this request for maximal degradation before
    #   service started (TokenBucketAdmission mode="degrade")
    rejected: bool = dataclasses.field(compare=False, default=False)
    # ^ admission control shed the request: never served
    failed: bool = dataclasses.field(compare=False, default=False)
    # ^ serve_fn raised: the request produced no answer (run() keeps going)
    error: str = dataclasses.field(compare=False, default="")

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def slo_met(self) -> bool:
        return (not self.failed and not self.rejected
                and self.latency_s <= self.slo_s)

    @property
    def outcome(self) -> str:
        """How the request ended: "met" (deadline met cleanly),
        "degraded" (met, but only by shedding work), "missed" (served
        past its deadline), "rejected" (admission control shed it),
        "failed" (serve_fn raised)."""
        if self.rejected:
            return "rejected"
        if self.failed:
            return "failed"
        if self.latency_s > self.slo_s:
            return "missed"
        return "degraded" if self.degraded else "met"


class TokenBucketAdmission:
    """Per-tenant token-bucket admission control (module docstring).

    ``rate_per_s`` is each tenant's refill rate in requests/second — a
    single float (uniform fair share) or a ``{tenant: rate}`` dict;
    ``burst`` is the bucket depth (how far a tenant may burst past its
    rate).  ``mode="reject"`` sheds over-share requests; ``"degrade"``
    admits them flagged ``pre_degraded`` so the serving path applies the
    degradation ladder's floor instead of full-quality work.  Decisions at
    dequeue: a request whose realized queue wait already blew its SLO is
    always shed (mode notwithstanding, serving it is pure waste) and an
    idle device always admits (work-conserving).
    """

    def __init__(self, rate_per_s: Union[float, Dict[str, float]],
                 burst: float = 4.0, *, mode: str = "reject"):
        assert mode in ("reject", "degrade"), mode
        self.rate_per_s = rate_per_s
        self.burst = float(burst)
        self.mode = mode
        self._tokens: Dict[str, float] = {}
        self._last: Dict[str, float] = {}
        self.admitted: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}       # rejected or pre-degraded
        self.blown: Dict[str, int] = {}      # shed for already-blown SLO

    def _rate(self, tenant: str) -> float:
        if isinstance(self.rate_per_s, dict):
            return float(self.rate_per_s.get(tenant, 0.0))
        return float(self.rate_per_s)

    def decide(self, req: Request, clock: float) -> str:
        """"admit" | "reject" | "degrade" for ``req`` dequeued at
        ``clock`` (modeled seconds; ``clock - arrival_s`` is the queue
        wait the request has already paid).  The bucket refills up to the
        request's arrival, not up to ``clock``."""
        t = req.tenant
        now = req.arrival_s
        tokens = self._tokens.get(t, self.burst)
        last = self._last.get(t, now)
        tokens = min(self.burst,
                     tokens + max(0.0, now - last) * self._rate(t))
        self._last[t] = now
        wait = max(0.0, clock - req.arrival_s)
        if wait >= req.slo_s:
            # the queue alone already blew the deadline — shed
            self.blown[t] = self.blown.get(t, 0) + 1
            decision = "reject" if self.mode == "reject" else "degrade"
        elif tokens >= 1.0:
            tokens -= 1.0
            decision = "admit"
        elif wait <= 0.0:
            decision = "admit"      # idle device: fair share doesn't bind
        else:
            decision = "reject" if self.mode == "reject" else "degrade"
        self._tokens[t] = tokens
        bucket = self.admitted if decision == "admit" else self.shed
        bucket[t] = bucket.get(t, 0) + 1
        return decision

    def stats(self) -> Dict[str, Dict[str, int]]:
        tenants = set(self.admitted) | set(self.shed)
        return {t: {"admitted": self.admitted.get(t, 0),
                    "shed": self.shed.get(t, 0),
                    "blown_slo": self.blown.get(t, 0)}
                for t in sorted(tenants)}


class RequestScheduler:
    def __init__(self, admission: Optional[TokenBucketAdmission] = None):
        self._queue: List[Request] = []
        self.completed: List[Request] = []
        self._next_rid = 0
        self.maintenance_s = 0.0     # total deferred-maintenance seconds
        self.errors: List[str] = []  # serve_fn exceptions (failed requests)
        self.pipeline_trace = None   # PipelineTrace from run_pipelined
        self.pipeline_responses = []  # flat RAGResponses from run_pipelined
        self.admission = admission   # per-tenant SLO-aware admission

    def submit(self, arrival_s: float, query: str = "", query_emb=None,
               query_chars: int = 0, slo_s: float = 1.0,
               tenant: str = "") -> Request:
        req = Request(arrival_s=arrival_s, rid=self._next_rid, query=query,
                      query_emb=query_emb, query_chars=query_chars,
                      slo_s=slo_s, tenant=tenant)
        self._next_rid += 1
        # Requests compare on arrival_s alone, so the heap's structure
        # orders equal arrivals, exactly as in the reference
        heapq.heappush(self._queue, req)
        return req

    def run(self, serve_fn: Callable[[Request], float],
            maintenance_fn: Optional[Callable[[Optional[float]], float]]
            = None) -> List[Request]:
        """Drain the queue; serve_fn returns the service time in seconds.

        The device is serially occupied (edge device: one query at a time);
        queueing delay accrues when arrivals outpace service.

        Each request carries its OWN deadline (``slo_s``, set at submit);
        ``serve_fn`` may set ``req.degraded`` to flag that the degradation
        ladder shed work for this request — its ``outcome`` then reports
        "met" / "degraded" / "missed" / "failed" per request.  A
        ``serve_fn`` that RAISES marks the request failed (error recorded
        on the request and in ``self.errors``) and the loop keeps serving:
        one bad request can no longer wedge the queue.

        ``maintenance_fn`` (deferred index maintenance, wrapping
        ``MaintenanceScheduler.drain``) models background work that YIELDS
        to foreground requests: it only runs when the device goes idle — no
        request waiting at the current clock — and receives the idle gap
        until the next known arrival (None when the queue is empty) so it
        can size its work to fit (a strict-budget drain).  It returns the
        modeled seconds it occupied the device; work that fits the gap is
        free, overrun delays the next request by the overrun only.  Under
        sustained backlog maintenance keeps deferring.
        """
        clock = 0.0
        while self._queue:
            req = heapq.heappop(self._queue)
            clock = max(clock, req.arrival_s)
            if self.admission is not None:
                decision = self.admission.decide(req, clock)
                if decision == "reject":
                    # shed without occupying the device: the clock does
                    # not advance, so the backlog behind this request
                    # drains sooner — that is the point
                    req.rejected = True
                    req.start_s = req.finish_s = clock
                    self.completed.append(req)
                    continue
                if decision == "degrade":
                    req.pre_degraded = True
            req.start_s = clock
            try:
                service_s = float(serve_fn(req))
            except Exception as e:     # noqa: BLE001 — isolate the request
                service_s = 0.0
                req.failed = True
                req.error = f"{type(e).__name__}: {e}"
                self.errors.append(req.error)
            clock += service_s
            req.finish_s = clock
            self.completed.append(req)
            if maintenance_fn is not None:
                nxt = self._queue[0].arrival_s if self._queue else None
                if nxt is None or nxt > clock:       # device idle: drain
                    gap = None if nxt is None else nxt - clock
                    m = float(maintenance_fn(gap))
                    self.maintenance_s += m
                    clock += m
        return self.completed

    def run_pipelined(self, pipeline, *, batch_size: int = 8,
                      policy=None) -> List[Request]:
        """Drain the queue through a
        :class:`~repro_torch.serving.pipeline.StagedPipeline` instead of
        the serial ``serve_fn`` loop: requests are grouped into
        arrival-order batches of ``batch_size`` and the pipeline overlaps
        each batch's retrieval with its predecessors' decode on the
        modeled clock.

        A batch is admitted when its LAST member has arrived (the batch's
        ``arrival_s``); each member's queue wait — admission wait plus any
        stage-queue wait — is charged against its deadline by the
        pipeline, so the degradation ladder sees the time actually left.
        Request ``start_s`` / ``finish_s`` are stamped by the pipeline
        (decode-stage entry / first token out) and the run's
        :class:`~repro_torch.serving.pipeline.PipelineTrace` lands on
        ``self.pipeline_trace``.
        """
        from repro_torch.serving.pipeline import PipelineBatch

        reqs = []
        while self._queue:
            req = heapq.heappop(self._queue)
            if self.admission is not None:
                # batch admission: token-bucket fair share only (stage
                # queue waits are the pipeline's to degrade against)
                decision = self.admission.decide(req, req.arrival_s)
                if decision == "reject":
                    req.rejected = True
                    req.start_s = req.finish_s = req.arrival_s
                    self.completed.append(req)
                    continue
                if decision == "degrade":
                    req.pre_degraded = True
            reqs.append(req)
        batches = []
        any_tenant = any(r.tenant for r in reqs)
        for i in range(0, len(reqs), batch_size):
            group = reqs[i:i + batch_size]
            batches.append(PipelineBatch(
                queries=[r.query for r in group],
                query_embs=[r.query_emb for r in group],
                arrival_s=max(r.arrival_s for r in group),
                slos=[r.slo_s for r in group],
                policy=policy,
                requests=group,
                tenants=[r.tenant for r in group] if any_tenant else None))
        responses, trace = pipeline.run(batches)
        self.pipeline_trace = trace
        self.maintenance_s += (trace.maintenance_in_bubbles_s
                               + trace.final_drain_s)
        self.completed.extend(reqs)
        self.pipeline_responses = [r for batch in responses for r in batch]
        return self.completed

    def slo_hit_rate(self) -> float:
        if not self.completed:
            return 1.0
        return sum(r.slo_met for r in self.completed) / len(self.completed)

    def outcome_counts(self) -> dict:
        """Per-outcome request counts: met / degraded / missed / rejected /
        failed."""
        counts = {"met": 0, "degraded": 0, "missed": 0, "rejected": 0,
                  "failed": 0}
        for r in self.completed:
            counts[r.outcome] += 1
        return counts
