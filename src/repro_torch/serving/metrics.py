"""Lightweight Prometheus-style serving metrics (no dependencies).

Port of ``repro.serving.metrics``: the registry and the two collectors
that read the scheduler and the staged pipeline.  The durability and
tenant-router collectors (``collect_durability``, ``collect_router``) come
with the port of those subsystems.

The serving layer needs per-tenant observability — request outcomes, TTFT
tails, queue waits, admission sheds, stage occupancy — in a form an
operator's scraper understands.  This module is a minimal text-exposition
implementation: :class:`Counter` / :class:`Gauge` / :class:`Histogram` with
label sets, a :class:`MetricsRegistry` that renders the standard
``# HELP`` / ``# TYPE`` / sample-line format, and collectors that populate
a registry from the serving objects the port produces
(:class:`~repro_torch.serving.scheduler.RequestScheduler`,
:class:`~repro_torch.serving.pipeline.PipelineTrace`).

Metric names follow Prometheus conventions (``_total`` counters, base-unit
``_seconds``); histograms expose cumulative ``_bucket`` samples with an
``le`` label plus ``_sum`` / ``_count``.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelKV = Tuple[Tuple[str, str], ...]

# TTFT-oriented default buckets: 1 ms .. 60 s, roughly log-spaced
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_ESCAPES = str.maketrans({"\\": r"\\", "\n": r"\n", '"': r'\"'})


def _labels_kv(labels: Optional[Dict[str, str]]) -> LabelKV:
    return tuple(sorted((k, str(v)) for k, v in (labels or {}).items()))


def _fmt_labels(kv: LabelKV) -> str:
    if not kv:
        return ""
    inner = ",".join(f'{k}="{v.translate(_ESCAPES)}"' for k, v in kv)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text

    def samples(self) -> Iterable[Tuple[str, LabelKV, float]]:
        raise NotImplementedError

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for suffix, kv, value in self.samples():
            lines.append(
                f"{self.name}{suffix}{_fmt_labels(kv)} {_fmt_value(value)}")
        return "\n".join(lines)


class Counter(_Metric):
    """Monotonic counter with label sets (``inc`` only)."""
    kind = "counter"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._values: Dict[LabelKV, float] = {}

    def inc(self, amount: float = 1.0,
            labels: Optional[Dict[str, str]] = None):
        assert amount >= 0, f"counter {self.name} cannot decrease"
        kv = _labels_kv(labels)
        self._values[kv] = self._values.get(kv, 0.0) + amount

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_labels_kv(labels), 0.0)

    def samples(self):
        for kv in sorted(self._values):
            yield "", kv, self._values[kv]


class Gauge(_Metric):
    """Point-in-time value with label sets (``set`` / ``inc``)."""
    kind = "gauge"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._values: Dict[LabelKV, float] = {}

    def set(self, value: float, labels: Optional[Dict[str, str]] = None):
        self._values[_labels_kv(labels)] = float(value)

    def inc(self, amount: float = 1.0,
            labels: Optional[Dict[str, str]] = None):
        kv = _labels_kv(labels)
        self._values[kv] = self._values.get(kv, 0.0) + amount

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_labels_kv(labels), 0.0)

    def samples(self):
        for kv in sorted(self._values):
            yield "", kv, self._values[kv]


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus exposition semantics)."""
    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets))
        assert self.buckets, "histogram needs at least one bucket"
        self._counts: Dict[LabelKV, List[int]] = {}
        self._sum: Dict[LabelKV, float] = {}
        self._count: Dict[LabelKV, int] = {}

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None):
        kv = _labels_kv(labels)
        counts = self._counts.setdefault(kv, [0] * len(self.buckets))
        for i, le in enumerate(self.buckets):
            if value <= le:
                counts[i] += 1
        self._sum[kv] = self._sum.get(kv, 0.0) + float(value)
        self._count[kv] = self._count.get(kv, 0) + 1

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        return self._count.get(_labels_kv(labels), 0)

    def sum(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._sum.get(_labels_kv(labels), 0.0)

    def quantile(self, q: float,
                 labels: Optional[Dict[str, str]] = None) -> float:
        """Bucket-interpolated quantile (what a PromQL
        ``histogram_quantile`` would report for this exposition)."""
        kv = _labels_kv(labels)
        counts = self._counts.get(kv)
        total = self._count.get(kv, 0)
        if not counts or not total:
            return 0.0
        target = q * total
        prev_le, prev_c = 0.0, 0
        for le, c in zip(self.buckets, counts):
            if c >= target:
                if c == prev_c:
                    return le
                frac = (target - prev_c) / (c - prev_c)
                return prev_le + frac * (le - prev_le)
            prev_le, prev_c = le, c
        return self.buckets[-1]

    def samples(self):
        for kv in sorted(self._counts):
            counts = self._counts[kv]
            for le, c in zip(self.buckets, counts):
                yield "_bucket", kv + (("le", _fmt_value(le)),), float(c)
            yield ("_bucket", kv + (("le", "+Inf"),),
                   float(self._count[kv]))
            yield "_sum", kv, self._sum[kv]
            yield "_count", kv, float(self._count[kv])


class MetricsRegistry:
    """Holds metrics by name; ``render()`` is the scrape payload."""

    def __init__(self):
        self._metrics: "Dict[str, _Metric]" = {}

    def _register(self, metric: _Metric) -> _Metric:
        existing = self._metrics.get(metric.name)
        if existing is not None:
            assert type(existing) is type(metric), \
                f"metric {metric.name} re-registered with a different type"
            return existing
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._register(Counter(name, help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._register(Gauge(name, help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_text, buckets))

    def get(self, name: str) -> _Metric:
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def render(self) -> str:
        """Prometheus text exposition format, trailing newline included."""
        blocks = [self._metrics[n].render()
                  for n in sorted(self._metrics)]
        return "\n".join(blocks) + ("\n" if blocks else "")


# ----------------------------------------------------------------------
# collectors: serving objects -> registry
# ----------------------------------------------------------------------
def collect_scheduler(reg: MetricsRegistry, sched) -> MetricsRegistry:
    """Per-tenant request outcomes, TTFT histograms, queue waits, and
    admission counters from a :class:`RequestScheduler` run."""
    outcomes = reg.counter("edgerag_requests_total",
                           "Completed requests by tenant and outcome")
    ttft = reg.histogram("edgerag_request_ttft_seconds",
                         "Arrival-to-first-token latency")
    wait = reg.histogram("edgerag_request_queue_wait_seconds",
                         "Arrival-to-service-start queue wait")
    for r in sched.completed:
        labels = {"tenant": r.tenant or "default"}
        outcomes.inc(labels={**labels, "outcome": r.outcome})
        if not r.rejected and not r.failed:
            ttft.observe(r.latency_s, labels=labels)
            wait.observe(max(0.0, r.start_s - r.arrival_s), labels=labels)
    reg.gauge("edgerag_maintenance_drained_seconds",
              "Deferred-maintenance edge seconds drained by the scheduler"
              ).set(sched.maintenance_s)
    if getattr(sched, "admission", None) is not None:
        adm = reg.counter("edgerag_admission_decisions_total",
                          "Admission decisions by tenant and decision")
        for t, st in sched.admission.stats().items():
            labels = {"tenant": t or "default"}
            adm.inc(st["admitted"],
                    labels={**labels, "decision": "admitted"})
            adm.inc(st["shed"], labels={**labels, "decision": "shed"})
            adm.inc(st["blown_slo"],
                    labels={**labels, "decision": "blown_slo"})
    return reg


def collect_pipeline_trace(reg: MetricsRegistry, trace) -> MetricsRegistry:
    """Stage occupancy / overlap figures from a
    :class:`~repro_torch.serving.pipeline.PipelineTrace`."""
    busy = reg.gauge("edgerag_stage_busy_seconds",
                     "Modeled busy seconds per pipeline stage")
    fired = reg.gauge("edgerag_stage_fired_total",
                      "Batch firings per pipeline stage")
    depth = reg.gauge("edgerag_stage_max_queue_depth",
                      "Deepest queue observed per pipeline stage")
    maint = reg.gauge("edgerag_stage_maintenance_seconds",
                      "Bubble seconds filled with maintenance per stage")
    for name, st in trace.stages.items():
        labels = {"stage": name}
        busy.set(st.busy_s, labels=labels)
        fired.set(st.n_fired, labels=labels)
        depth.set(st.max_queue_depth, labels=labels)
        maint.set(st.maintenance_s, labels=labels)
    reg.gauge("edgerag_pipeline_makespan_seconds",
              "First arrival to last decode completion").set(trace.makespan_s)
    reg.gauge("edgerag_pipeline_hidden_retrieval_fraction",
              "Fraction of retrieval time hidden under decode"
              ).set(trace.hidden_retrieval_fraction)
    reg.gauge("edgerag_pipeline_replans_total",
              "Stale-plan S1 re-entries").set(trace.replans)
    return reg

