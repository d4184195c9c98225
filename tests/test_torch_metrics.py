"""The port's metrics registry (``repro_torch.serving.metrics``) against the
JAX package's.

The registry cases of ``tests/test_metrics.py`` (primitives, exposition
format, name collisions, label escaping) run on both packages and must
render byte-equal text, give the same ``value`` / ``count`` / ``sum`` /
``quantile`` readings and raise on the same misuse.  The collectors are
held on scheduler runs: ``collect_scheduler`` on the admission case of
``tests/test_metrics.py`` here, and ``collect_scheduler`` /
``collect_pipeline_trace`` on every run of ``tests/test_torch_scheduler.py``
there.  ``collect_router`` renders byte-equal text from the JAX router
and a port router on its clustering after the same traffic, without and
with durability enabled, and ``collect_durability`` byte-equal text from
a JAX and a port index with a durability handle after the same inserts.
"""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import Durability as JaxDurability  # noqa: E402
from repro.core import EdgeCostModel as JaxCost  # noqa: E402
from repro.core import EdgeRAGIndex as JaxIndex  # noqa: E402
from repro.core import TenantRouter as JaxRouter  # noqa: E402
from repro.data import generate_dataset as jax_dataset  # noqa: E402
from repro.serving import metrics as jax_metrics  # noqa: E402
from repro.serving import scheduler as jax_sched  # noqa: E402
from repro_torch.convert import index_state_from_numpy  # noqa: E402
from repro_torch.core import (Durability, EdgeCostModel,  # noqa: E402
                              EdgeRAGIndex, TenantRouter)
from repro_torch.data import generate_dataset  # noqa: E402
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


def _router_texts(root=None):
    """Two tenants on a shared cache small enough to evict, a storage
    budget that refuses puts, two rounds of traffic each and one online
    insert left queued, in each package (durability enabled under
    ``root`` when one is given): the port router and both texts."""
    data = [dict(n_records=200, dim=16, n_topics=6, n_queries=6,
                 seed=60 + t) for t in range(2)]
    kw = dict(slo_s=0.002, cache_bytes=6_000, storage_budget_bytes=12_000)
    jr = JaxRouter(16, JaxCost(), **kw)
    pr = TenantRouter(16, EdgeCostModel(), device="cpu", **kw)
    sides = []
    for t, d in enumerate(data):
        jds, ds = jax_dataset(**d), generate_dataset(**d)
        jix = jr.create_tenant(f"t{t}", jds.embedder, jds.get_chunks)
        assign = jix.build(jds.chunk_ids, jds.texts, nlist=8,
                           embeddings=jds.embeddings, seed=1)
        index_state_from_numpy(
            pr.create_tenant(f"t{t}", ds.embedder, ds.get_chunks),
            jix.centroids, assign, ds.chunk_ids, ds.texts, ds.embeddings)
        sides.append((jds, ds))
    if root is not None:
        jr.enable_durability(str(root / "jax"), checkpoint_every=2)
        pr.enable_durability(str(root / "port"), checkpoint_every=2)
    texts = []
    for router, side, m in ((jr, 0, jax_metrics), (pr, 1, metrics)):
        for _ in range(2):
            for t in range(2):
                router.search_batch(sides[t][side].query_embs, 5, 3,
                                    tenants=f"t{t}")
        emb = np.ones(16, np.float32) / 4.0
        sides[0][side].add_chunk(10_000, "doc-10000 " + "tok " * 40, emb)
        router.tenant("t0").insert(10_000, "doc-10000 " + "tok " * 40)
        texts.append(m.collect_router(m.MetricsRegistry(), router).render())
    return pr, texts


def test_collect_router_renders_like_jax():
    """The same router text from both packages (``_router_texts``)."""
    pr, texts = _router_texts()
    assert pr.storage.io_stats["put_rejected"] > 0
    assert any(st["evictions"] for st in pr.cache.per_tenant.values())
    assert "edgerag_storage_bytes{tenant=\"t1\"}" in texts[1]
    assert "edgerag_wal_records_total" not in texts[1]
    assert texts[1] == texts[0]


def test_collect_router_with_durability_renders_like_jax(tmp_path):
    """The same, durability enabled (per-tenant WALs under a root of each
    package's own): every tenant's durability samples too."""
    _, texts = _router_texts(tmp_path)
    assert "edgerag_wal_records_total{tenant=\"t0\"} 1" in texts[1]
    assert "edgerag_snapshots_total{tenant=\"t1\"} 1" in texts[1]
    assert texts[1] == texts[0]


def test_collect_durability_renders_like_jax(tmp_path):
    """An index of each package on the same clustering and a durability
    handle each, five inserts (one checkpoint every three records): the
    same WAL bytes and the same ``collect_durability`` text."""
    d = dict(n_records=80, dim=16, n_topics=4, n_queries=2, seed=31)
    jds, ds = jax_dataset(**d), generate_dataset(**d)
    kw = dict(slo_s=0.004, storage_mode="disk", maintenance="sync")
    jix = JaxIndex(16, jds.embedder, jds.get_chunks,
                   storage_root=str(tmp_path / "jax"), **kw)
    assign = jix.build(jds.chunk_ids, jds.texts, nlist=4,
                       embeddings=jds.embeddings)
    pix = EdgeRAGIndex(16, ds.embedder, ds.get_chunks, device="cpu",
                       storage_root=str(tmp_path / "port"), **kw)
    index_state_from_numpy(pix, jix.centroids, assign, ds.chunk_ids,
                           ds.texts, ds.embeddings)
    durs = [jix.attach_durability(JaxDurability(str(tmp_path / "jax"),
                                                checkpoint_every=3)),
            pix.attach_durability(Durability(str(tmp_path / "port"),
                                             checkpoint_every=3))]
    for side, ix in ((jds, jix), (ds, pix)):
        for j in range(5):
            side.add_chunk(9_000 + j, f"fresh chunk {j} " * 20)
            ix.insert(9_000 + j, f"fresh chunk {j} " * 20)
    assert durs[0].stats() == durs[1].stats()
    assert durs[1].stats()["wal_records_total"] == 5
    assert durs[1].stats()["snapshots_total"] == 2
    assert (tmp_path / "jax" / "durability" / "wal.log").read_bytes() \
        == (tmp_path / "port" / "durability" / "wal.log").read_bytes()
    texts = [m.collect_durability(m.MetricsRegistry(), dur,
                                  labels={"tenant": "x"}).render()
             for m, dur in ((jax_metrics, durs[0]), (metrics, durs[1]))]
    assert "edgerag_recovery_seconds{tenant=\"x\"} 0" in texts[1]
    assert texts[1] == texts[0]
