"""The port's metrics registry (``repro_torch.serving.metrics``) against the
JAX package's.

The registry cases of ``tests/test_metrics.py`` (primitives, exposition
format, name collisions, label escaping) run on both packages and must
render byte-equal text, give the same ``value`` / ``count`` / ``sum`` /
``quantile`` readings and raise on the same misuse.  The collectors are
held on scheduler runs: ``collect_scheduler`` on the admission case of
``tests/test_metrics.py`` here, and ``collect_scheduler`` /
``collect_pipeline_trace`` on every run of ``tests/test_torch_scheduler.py``
there.  The durability and tenant-router collectors are not ported yet.
"""
import pytest

pytest.importorskip("torch")

from repro.serving import metrics as jax_metrics  # noqa: E402
from repro.serving import scheduler as jax_sched  # noqa: E402
from repro_torch.serving import metrics  # noqa: E402
from repro_torch.serving import scheduler  # noqa: E402

PACKAGES = {"jax": (jax_metrics, jax_sched), "port": (metrics, scheduler)}


def _counter(m):
    reg = m.MetricsRegistry()
    c = reg.counter("edgerag_requests_total", "Requests.")
    c.inc(labels={"tenant": "a", "outcome": "met"})
    c.inc(2.0, labels={"tenant": "a", "outcome": "met"})
    c.inc(labels={"tenant": "b", "outcome": "missed"})
    with pytest.raises(AssertionError):
        c.inc(-1.0, labels={"tenant": "a"})
    return reg, [c.value({"tenant": "a", "outcome": "met"}),
                 c.value({"outcome": "met", "tenant": "a"}),
                 c.value({"tenant": "b", "outcome": "missed"}),
                 c.value({"tenant": "zz", "outcome": "met"})]


def _gauge(m):
    reg = m.MetricsRegistry()
    g = reg.gauge("edgerag_cache_bytes", "Bytes.")
    g.set(10.0, labels={"tenant": "a"})
    g.set(4.0, labels={"tenant": "a"})
    seen = [g.value({"tenant": "a"})]
    g.inc(1.5, labels={"tenant": "a"})
    g.set(7.0)
    return reg, seen + [g.value({"tenant": "a"}), g.value()]


def _histogram_buckets(m):
    reg = m.MetricsRegistry()
    h = reg.histogram("h_seconds", "H.", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    return reg, [list(h.samples()), h.count(), h.sum()]


def _histogram_quantile(m):
    reg = m.MetricsRegistry()
    h = reg.histogram("h_seconds", "H.", buckets=(1.0, 2.0, 4.0))
    for v in [0.5] * 50 + [1.5] * 50:
        h.observe(v)
    return reg, [h.quantile(q) for q in (0.0, 0.25, 0.5, 0.75, 0.99, 1.0)
                 ] + [m.Histogram("e", "E.").quantile(0.5)]


def _default_buckets(m):
    reg = m.MetricsRegistry()
    h = reg.histogram("edgerag_ttft_seconds", "TTFT.")
    for v in (0.0005, 0.003, 0.2, 1.7, 75.0):
        h.observe(v)
    return reg, [m.DEFAULT_BUCKETS, h.buckets, h.quantile(0.9)]


def _render_format(m):
    reg = m.MetricsRegistry()
    reg.counter("edgerag_requests_total", "Total requests.").inc(
        labels={"tenant": "alice"})
    reg.gauge("edgerag_memory_bytes", "Resident bytes.").set(123.0)
    reg.histogram("edgerag_ttft_seconds", "TTFT.", buckets=(1.0,)
                  ).observe(0.5)
    return reg, [m.MetricsRegistry().render()]


def _same_name(m):
    reg = m.MetricsRegistry()
    a = reg.counter("x_total", "X.")
    b = reg.counter("x_total", "X.")
    with pytest.raises(AssertionError):
        reg.gauge("x_total", "X.")
    return reg, [a is b, "x_total" in reg, "y_total" in reg]


def _escaping(m):
    reg = m.MetricsRegistry()
    reg.counter("x_total", "X.").inc(labels={"tenant": 'we"ird\\te\nnant'})
    reg.gauge("y", "Y.").set(0.1 + 0.2, labels={"a": "1", "b": ""})
    reg.gauge("z", "Z.").set(1e16)
    return reg, [m._fmt_value(float("inf")), m._fmt_value(-3.0),
                 m._labels_kv({"b": 2, "a": "x"}),
                 m._fmt_labels(m._labels_kv({"q": 'a"b'}))]


CASES = {"counter_inc_and_labels": _counter,
         "gauge_set_and_overwrite": _gauge,
         "histogram_buckets_are_cumulative": _histogram_buckets,
         "histogram_quantile_interpolates": _histogram_quantile,
         "default_buckets_span_serving_range": _default_buckets,
         "registry_render_format": _render_format,
         "registry_same_name_returns_same_metric": _same_name,
         "label_value_escaping": _escaping}


@pytest.mark.parametrize("name", list(CASES))
def test_registry_case(name):
    out = {pkg: CASES[name](m) for pkg, (m, _) in PACKAGES.items()}
    (p_reg, p_vals), (r_reg, r_vals) = out["port"], out["jax"]
    assert p_reg.render() == r_reg.render()
    assert p_vals == r_vals
    assert p_reg.render().endswith("\n")


def test_collect_scheduler_counts_and_admission():
    texts = []
    for m, s in PACKAGES.values():
        adm = s.TokenBucketAdmission(rate_per_s=1.0, burst=1.0)
        sched = s.RequestScheduler(admission=adm)
        for i in range(10):
            sched.submit(i * 0.01, slo_s=100.0, tenant="a")
        sched.run(lambda req: 0.5)
        reg = m.collect_scheduler(m.MetricsRegistry(), sched)
        counts = sched.outcome_counts()
        req_total = reg.get("edgerag_requests_total")
        assert req_total.value(
            {"tenant": "a", "outcome": "met"}) == counts["met"]
        assert req_total.value(
            {"tenant": "a", "outcome": "rejected"}) == counts["rejected"] > 0
        dec = reg.get("edgerag_admission_decisions_total")
        assert (dec.value({"tenant": "a", "decision": "admitted"})
                == adm.admitted["a"])
        assert dec.value({"tenant": "a", "decision": "shed"}) == adm.shed["a"]
        served = counts["met"] + counts["missed"]
        assert reg.get("edgerag_request_ttft_seconds").count(
            {"tenant": "a"}) == served
        assert served + counts["rejected"] == 10
        texts.append(reg.render())
    assert texts[0] == texts[1]
