"""The port's request scheduler (``repro_torch.serving.scheduler``) against
the JAX package's.

Each case runs the same submissions, ``serve_fn`` and ``maintenance_fn`` on
both packages' ``RequestScheduler`` and compares, exactly: every completed
request's fields in completion order, ``errors``, ``maintenance_s``,
``admission.stats()``, ``slo_hit_rate()``, ``outcome_counts()``, the gaps
``maintenance_fn`` was given, and the text ``collect_scheduler`` renders
from the run.  Both schedulers are the same pure-Python arithmetic on the
same floats in the same order, so nothing is compared within a tolerance
except the S3 scores of ``run_pipelined``: fp32 scores of unit vectors in
D = 32 summed in two orders differ by at most 2 * 32 * 2**-24 * sum|q_i
e_i| <= 4e-6 (``TOL``), as in ``tests/test_torch_pipeline.py``.

The cases: the scheduler tests of the JAX suite
(``test_serving_train.py::test_scheduler_slo_accounting``,
``test_faults.py::test_scheduler_per_request_outcomes``,
``test_maintenance.py::test_request_scheduler_maintenance_hook`` and the
five admission tests of ``test_tenant.py``), a seeded fuzz over 200
traces, and ``run_pipelined`` at ``tests/test_pipeline.py``'s sizes with
and without admission, and on tenant-tagged requests over a
``TenantRouter``.
"""
import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import EdgeCostModel as JaxCost  # noqa: E402
from repro.core import EdgeRAGIndex as JaxIndex  # noqa: E402
from repro.core import TenantRouter as JaxRouter  # noqa: E402
from repro.data import generate_dataset as jax_dataset  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving import metrics as jax_metrics  # noqa: E402
from repro.serving import scheduler as jax_sched  # noqa: E402
from repro.serving.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from repro.serving.engine import RAGEngine as JaxEngine  # noqa: E402
from repro.serving.pipeline import StagedPipeline as JaxPipeline  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (index_state_from_numpy,  # noqa: E402
                                 params_from_jax)
from repro_torch.core import (EdgeCostModel, EdgeRAGIndex,  # noqa: E402
                              TenantRouter)
from repro_torch.data import generate_dataset  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, RAGEngine,  # noqa: E402
                                 StagedPipeline)
from repro_torch.serving import metrics  # noqa: E402
from repro_torch.serving import scheduler  # noqa: E402

PACKAGES = {"jax": (jax_sched, jax_metrics), "port": (scheduler, metrics)}
FUZZ_TRACES = 200
REQUEST_FIELDS = [f.name for f in dataclasses.fields(scheduler.Request)
                  if f.name != "query_emb"]

DIM, K, NPROBE, NLIST = 32, 5, 5, 16
TOL = 4e-6
DATA = dict(n_records=500, dim=DIM, n_topics=16, n_queries=24, seed=5)
SLO_S = 0.15
QUERIES = 4


def _request(r):
    return tuple(getattr(r, f) for f in REQUEST_FIELDS) + (
        r.latency_s, r.slo_met, r.outcome)


def _state(sched, mod_metrics):
    """Everything a scheduler run left behind, as plain values."""
    reg = mod_metrics.collect_scheduler(mod_metrics.MetricsRegistry(), sched)
    return {"completed": [_request(r) for r in sched.completed],
            "queue": len(sched._queue), "errors": list(sched.errors),
            "maintenance_s": sched.maintenance_s,
            "stats": (None if sched.admission is None
                      else sched.admission.stats()),
            "slo_hit_rate": sched.slo_hit_rate(),
            "outcome_counts": sched.outcome_counts(),
            "metrics": reg.render()}


def _run_both(case):
    """``case(mod)`` -> (scheduler, extra) on each package; returns the
    port's scheduler after holding both states and extras equal."""
    out = {}
    for name, (mod, mod_metrics) in PACKAGES.items():
        sched, extra = case(mod)
        out[name] = (sched, _state(sched, mod_metrics), extra)
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2]
    return out["port"][0]


def test_request_fields_and_order():
    """The same fields in the same order, and ``order=True`` on
    ``arrival_s`` alone: requests that arrive together compare equal."""
    fields = [(f.name, f.compare) for f in dataclasses.fields(
        scheduler.Request)]
    assert fields == [(f.name, f.compare) for f in dataclasses.fields(
        jax_sched.Request)]
    assert [n for n, c in fields if c] == ["arrival_s"]
    a = scheduler.Request(arrival_s=1.0, rid=0, tenant="x")
    b = scheduler.Request(arrival_s=1.0, rid=1, slo_s=9.0)
    assert a == b and not a < b and a < scheduler.Request(2.0, rid=2)


# ----------------------------------------------------------------------
# the JAX suite's scheduler cases
# ----------------------------------------------------------------------
def _slo_accounting(mod):
    sched = mod.RequestScheduler()
    for i in range(10):
        sched.submit(arrival_s=i * 0.1, slo_s=0.5)
    sched.run(lambda req: 0.3)
    return sched, None


def _per_request_outcomes(mod):
    rs = mod.RequestScheduler()
    rs.submit(0.0, query="a", slo_s=1.0)
    rs.submit(1.0, query="b", slo_s=0.05)
    rs.submit(2.0, query="c", slo_s=0.01)
    rs.submit(3.0, query="d", slo_s=1.0)

    def serve(req):
        if req.query == "d":
            raise RuntimeError("backend exploded")
        if req.query == "b":
            req.degraded = True
            return 0.04
        return 0.02 if req.query == "a" else 0.05
    rs.run(serve)
    return rs, None


def _maintenance_hook(mod):
    sched = mod.RequestScheduler()
    for arrival in (0.0, 10.0, 10.1):
        sched.submit(arrival)
    gaps = []

    def maintenance(gap_s):
        gaps.append(gap_s)
        return 5.0
    sched.run(lambda r: 1.0, maintenance_fn=maintenance)
    return sched, gaps


def _rejects_over_share(mod):
    sched = mod.RequestScheduler(
        admission=mod.TokenBucketAdmission(rate_per_s=1.0, burst=1.0))
    for i in range(10):
        sched.submit(i * 0.01, slo_s=100.0, tenant="x")
    sched.run(lambda req: 0.5)
    return sched, None


def _work_conserving(mod):
    sched = mod.RequestScheduler(
        admission=mod.TokenBucketAdmission(rate_per_s=0.001, burst=1.0))
    for i in range(5):
        sched.submit(i * 10.0, slo_s=100.0, tenant="x")
    sched.run(lambda req: 0.5)
    return sched, None


def _sheds_blown(mod):
    adm = mod.TokenBucketAdmission(rate_per_s=100.0, burst=10.0)
    sched = mod.RequestScheduler(admission=adm)
    for i in range(6):
        sched.submit(i * 0.01, slo_s=0.2, tenant="x")
    sched.run(lambda req: 1.0)
    return sched, dict(adm.blown)


def _degrade_mode(mod):
    sched = mod.RequestScheduler(admission=mod.TokenBucketAdmission(
        rate_per_s=1.0, burst=1.0, mode="degrade"))
    for i in range(10):
        sched.submit(i * 0.01, slo_s=100.0, tenant="x")
    sched.run(lambda req: 0.5)
    return sched, None


def _protects_small(mod):
    """Both arms of the noisy-neighbour case; the extra is the arm
    without admission and the small tenant's p99 in each arm."""
    def arm(admission):
        sched = mod.RequestScheduler(admission=admission)
        for i in range(120):
            sched.submit(i / 30.0, slo_s=1.0, tenant="big")
        for j in range(12):
            sched.submit(j * 1.0, slo_s=1.0, tenant="small")
        sched.run(lambda req: 0.1)
        small = [r.latency_s for r in sched.completed
                 if r.tenant == "small" and not r.rejected]
        return sched, float(np.percentile(small, 99))
    off, p99_off = arm(None)
    on, p99_on = arm(mod.TokenBucketAdmission(rate_per_s=5.0, burst=2.0))
    return on, ([_request(r) for r in off.completed], p99_off, p99_on)


def _check_slo_accounting(s, _):
    assert s.completed[0].slo_met and not s.completed[-1].slo_met
    assert 0 < s.slo_hit_rate() < 1


def _check_outcomes(s, _):
    assert s.outcome_counts() == {"met": 1, "degraded": 1, "missed": 1,
                                  "failed": 1, "rejected": 0}
    assert s.errors == ["RuntimeError: backend exploded"]


def _check_maintenance(s, gaps):
    assert [r.latency_s for r in s.completed] == [1.0, 1.0,
                                                  12.0 - 10.1]
    assert s.maintenance_s == 10.0 and gaps == [9.0, None]


def _check_rejects(s, _):
    assert s.outcome_counts()["rejected"] > 0
    assert s.outcome_counts()["met"] >= 1
    assert all(r.finish_s == r.start_s for r in s.completed if r.rejected)


def _check_conserving(s, _):
    assert all(r.outcome == "met" for r in s.completed)


def _check_blown(s, blown):
    assert sum(r.rejected for r in s.completed) > 0 and sum(blown.values())


def _check_degrade(s, _):
    assert s.outcome_counts()["rejected"] == 0
    assert any(r.pre_degraded for r in s.completed)


def _check_small(_, extra):
    assert extra[2] < extra[1]


CASES = {
    "slo_accounting": (_slo_accounting, _check_slo_accounting),
    "per_request_outcomes": (_per_request_outcomes, _check_outcomes),
    "maintenance_hook": (_maintenance_hook, _check_maintenance),
    "admission_rejects_over_share": (_rejects_over_share, _check_rejects),
    "admission_work_conserving": (_work_conserving, _check_conserving),
    "admission_sheds_blown_deadline": (_sheds_blown, _check_blown),
    "admission_degrade_mode": (_degrade_mode, _check_degrade),
    "admission_protects_small_tenant": (_protects_small, _check_small),
}


@pytest.mark.parametrize("name", list(CASES))
def test_reference_case(name):
    case, check = CASES[name]
    sched = _run_both(case)
    extra = case(scheduler)[1]
    check(sched, extra)


# ----------------------------------------------------------------------
# a seeded fuzz over traces
# ----------------------------------------------------------------------
def _trace(seed):
    """One seeded trace: arrivals in bursts that share timestamps, SLOs,
    tenants, service times, a ``serve_fn`` that raises or sets
    ``degraded``, an admission (none, a float rate or a dict of rates;
    reject or degrade) and a ``maintenance_fn`` (or none)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    burst = rng.integers(1, 5, size=n)
    t, arrivals = 0.0, []
    for i in range(n):                   # a burst repeats one timestamp
        if i == 0 or rng.random() < 1.0 / burst[i]:
            t += float(rng.choice([0.0, rng.exponential(0.3)]))
        arrivals.append(t)
    order = rng.permutation(n)           # submitted out of arrival order
    tenants = ["", "a", "b", "c"][:int(rng.integers(1, 5))]
    reqs = [dict(arrival_s=arrivals[i], query=f"q{i}",
                 query_chars=int(rng.integers(0, 200)),
                 slo_s=float(rng.choice([0.0, 0.05, 0.3, 1.0, 5.0])),
                 tenant=str(rng.choice(tenants))) for i in order]
    service = rng.exponential(0.25, size=n)
    fate = rng.choice(["ok", "ok", "ok", "raise", "degraded"], size=n)
    kind = int(rng.integers(0, 3))
    rate = (None if kind == 0 else float(rng.uniform(0.2, 8.0)) if kind == 1
            else {tn: float(rng.uniform(0.0, 8.0))
                  for tn in tenants if rng.random() < 0.8})
    admission = None if rate is None else dict(
        rate_per_s=rate, burst=float(rng.choice([1.0, 2.0, 4.0])),
        mode=str(rng.choice(["reject", "degrade"])))
    maint = (None if rng.random() < 0.3
             else (float(rng.uniform(0.0, 0.5)), bool(rng.random() < 0.5)))
    return reqs, service, fate, admission, maint


def _fuzz_case(seed):
    reqs, service, fate, admission, maint = _trace(seed)

    def case(mod):
        sched = mod.RequestScheduler(
            admission=None if admission is None
            else mod.TokenBucketAdmission(**admission))
        for kw in reqs:
            sched.submit(**kw)
        gaps, seen = [], []

        def serve(req):
            seen.append(req.rid)
            if fate[req.rid] == "raise":
                raise (ValueError if req.rid % 2 else RuntimeError)(
                    f"request {req.rid} failed")
            req.degraded = fate[req.rid] == "degraded" or req.pre_degraded
            return service[req.rid]

        def drain(gap):
            gaps.append(gap)
            cost, fit = maint
            return cost if gap is None or not fit else min(cost, gap)
        sched.run(serve, maintenance_fn=None if maint is None else drain)
        return sched, (gaps, seen)
    return case


def test_fuzz_traces():
    outcomes = set()
    for seed in range(FUZZ_TRACES):
        sched = _run_both(_fuzz_case(seed))
        assert len(sched.completed) == sched._next_rid
        outcomes |= {r.outcome for r in sched.completed}
    assert outcomes == {"met", "degraded", "missed", "rejected", "failed"}


# ----------------------------------------------------------------------
# run_pipelined against the JAX package, at tests/test_pipeline.py's sizes
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def batcher_params():
    """One set of 2-layer generator weights in both packages' forms."""
    jcfg = jax_get_config("sheared-llama-2.7b").reduced(num_layers=2,
                                                         d_model=128)
    cfg = get_config("sheared-llama-2.7b").reduced(num_layers=2, d_model=128)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return (jcfg, params), (cfg, params_from_jax(
        jax.tree.map(np.asarray, params), cfg, device="cpu"))


def _pipelined_pair(device="cpu"):
    """(JAX index, port index on ``device``) on the JAX build's clustering,
    deferred maintenance and ``cache_bytes=0``, each with a long in-place
    rewrite of one chunk in each of two clusters no query probes (a restore
    each)."""
    jds, ds = jax_dataset(**DATA), generate_dataset(**DATA)
    kw = dict(slo_s=SLO_S, maintenance="deferred", cache_bytes=0)
    ref = JaxIndex(DIM, jds.embedder, jds.get_chunks, JaxCost(), **kw)
    assign = ref.build(jds.chunk_ids, jds.texts, nlist=NLIST,
                       embeddings=jds.embeddings, seed=1)
    port = EdgeRAGIndex(DIM, ds.embedder, ds.get_chunks, EdgeCostModel(),
                        device=device, **kw)
    index_state_from_numpy(port, ref.centroids, assign, ds.chunk_ids,
                           ds.texts, ds.embeddings)
    top = np.argsort(-(ds.query_embs[:QUERIES].astype(np.float64)
                       @ np.asarray(ref.centroids, np.float64).T),
                     axis=1)[:, :NPROBE]
    targets = [c for c in range(NLIST) if c not in set(top.ravel())][:2]
    assert targets
    for side_ds, er in ((jds, ref), (ds, port)):
        for cid in targets:
            chunk = int(er.clusters[cid].ids[0])
            text = f"doc-{chunk} rev " + "tok " * 1000
            side_ds.add_chunk(chunk, text, side_ds.embedder.table[chunk])
            er.update(chunk, text)
        assert len(er.maintenance) == len(targets)
    return (jds, ref), (ds, port)


def _scores(index):
    vals, finish = [], index.search_finish

    def logged(state):
        out = finish(state)
        vals.append(np.asarray(out[1]))
        return out
    index.search_finish = logged
    return vals


def _submit_eight(sched, ds):
    """8 requests 0.05 s apart (as ``tests/test_pipeline.py``) over the
    first ``QUERIES`` queries, whose narrow probe footprint leaves clusters
    for the seeded restores; SLOs from generous to 0 (a zero SLO is shed by
    admission as already blown)."""
    for i in range(8):
        sched.submit(0.05 * i, query=f"q{i}",
                     query_emb=ds.query_embs[i % QUERIES],
                     query_chars=3 + i, slo_s=(30.0, 2.0, 0.3, 0.0)[i % 4])


@pytest.mark.parametrize("admission", [None, "reject", "degrade"])
def test_run_pipelined_matches_jax(admission, batcher_params):
    (jcfg, jparams), (cfg, params) = batcher_params
    out = {}
    for name, (ds, index) in zip(PACKAGES, _pipelined_pair()):
        mod, mod_metrics = PACKAGES[name]
        port = name == "port"
        batcher = (ContinuousBatcher(cfg, params, num_slots=2, max_len=48,
                                     device="cpu") if port else
                   JaxBatcher(jcfg, jparams, num_slots=2, max_len=48))
        engine = (RAGEngine if port else JaxEngine)(
            index, None, k=K, nprobe=NPROBE, max_new_tokens=6,
            maintenance_owner="external")
        pipe = (StagedPipeline if port else JaxPipeline)(
            engine, ds.get_chunks, batcher=batcher)
        sched = mod.RequestScheduler(
            admission=None if admission is None else
            mod.TokenBucketAdmission(rate_per_s={"": 4.0}, burst=2.0,
                                     mode=admission))
        _submit_eight(sched, ds)
        scores = _scores(index)
        sched.run_pipelined(pipe, batch_size=3)
        reg = mod_metrics.collect_pipeline_trace(
            mod_metrics.MetricsRegistry(), sched.pipeline_trace)
        out[name] = dict(
            state=_state(sched, mod_metrics),
            trace=sched.pipeline_trace.as_dict(),
            intervals={s: st.intervals for s, st in
                       sched.pipeline_trace.stages.items()},
            responses=[(r.chunk_ids, r.output_tokens, r.ttft_edge_s,
                        r.queue_wait_s, r.outcome, r.deadline_s)
                       for r in sched.pipeline_responses],
            trace_metrics=reg.render(), scores=scores,
            left=len(index.maintenance))
    port, ref = out["port"], out["jax"]
    p_scores, r_scores = port.pop("scores"), ref.pop("scores")
    assert len(p_scores) == len(r_scores) > 0
    for p, r in zip(p_scores, r_scores):
        np.testing.assert_allclose(p, r, rtol=0, atol=TOL)
    assert port == ref
    counts = port["state"]["outcome_counts"]
    assert port["left"] == 0 and port["state"]["maintenance_s"] > 0
    assert port["state"]["maintenance_s"] == (
        port["trace"]["maintenance_in_bubbles_s"]
        + port["trace"]["final_drain_s"])
    assert counts["rejected"] == (0 if admission != "reject" else 2)
    assert len(port["responses"]) == 8 - counts["rejected"]
    assert all(len(r[1]) == 6 for r in port["responses"])


# ----------------------------------------------------------------------
# tenant-tagged requests through a TenantRouter
# ----------------------------------------------------------------------
def _router_pair():
    """(JAX router, port router on the CPU) with tenants "a" and "b", two
    corpora at ``DATA``'s sizes (seeds 5 and 6), each JAX tenant's
    clustering loaded into the port's; and the datasets per package."""
    routers, sets = {}, {}
    for name in PACKAGES:
        port = name == "port"
        kw = dict(slo_s=SLO_S, cache_bytes=1 << 20)
        routers[name] = (TenantRouter(DIM, EdgeCostModel(), device="cpu",
                                      **kw) if port else
                         JaxRouter(DIM, JaxCost(), **kw))
        sets[name] = {t: (generate_dataset if port else jax_dataset)(
            **{**DATA, "seed": seed}) for t, seed in (("a", 5), ("b", 6))}
    for t in ("a", "b"):
        jds, ds = sets["jax"][t], sets["port"][t]
        jix = routers["jax"].create_tenant(t, jds.embedder, jds.get_chunks)
        assign = jix.build(jds.chunk_ids, jds.texts, nlist=NLIST,
                           embeddings=jds.embeddings, seed=1)
        index_state_from_numpy(
            routers["port"].create_tenant(t, ds.embedder, ds.get_chunks),
            jix.centroids, assign, ds.chunk_ids, ds.texts, ds.embeddings)
    return routers, sets


def test_run_pipelined_serves_tenants_like_jax(batcher_params):
    """Tenant-tagged requests (tenants a and b behind per-tenant token
    buckets; a zero SLO is shed as already blown) through
    ``run_pipelined`` on a pipeline over a
    ``TenantRouter``: every request's fields, the trace, the responses and
    the collectors' text equal the JAX scheduler's, scores within TOL; and
    ``run`` serves tenant-tagged requests through admission too."""
    (jcfg, jparams), (cfg, params) = batcher_params
    routers, sets = _router_pair()
    out = {}
    for name, (mod, mod_metrics) in PACKAGES.items():
        port = name == "port"
        router = routers[name]
        batcher = (ContinuousBatcher(cfg, params, num_slots=2, max_len=48,
                                     device="cpu") if port else
                   JaxBatcher(jcfg, jparams, num_slots=2, max_len=48))
        engine = (RAGEngine if port else JaxEngine)(
            router, None, k=K, nprobe=NPROBE, max_new_tokens=6,
            maintenance_owner="external")
        pipe = (StagedPipeline if port else JaxPipeline)(
            engine, None, batcher=batcher)
        sched = mod.RequestScheduler(admission=mod.TokenBucketAdmission(
            rate_per_s={"a": 4.0, "b": 8.0}, burst=2.0, mode="reject"))
        for i, t in enumerate("aabababbaa"):
            sched.submit(0.02 * i, query=f"q{i}",
                         query_emb=sets[name][t].query_embs[i % QUERIES],
                         query_chars=3 + i,
                         slo_s=(30.0, 2.0, 0.3, 0.0)[i % 4], tenant=t)
        scores = _scores(router)
        sched.run_pipelined(pipe, batch_size=3)
        reg = mod_metrics.collect_pipeline_trace(
            mod_metrics.MetricsRegistry(), sched.pipeline_trace)
        out[name] = dict(
            state=_state(sched, mod_metrics),
            trace=sched.pipeline_trace.as_dict(),
            responses=[(r.chunk_ids, r.output_tokens, r.ttft_edge_s,
                        r.queue_wait_s, r.outcome, r.context)
                       for r in sched.pipeline_responses],
            trace_metrics=reg.render(), scores=scores)
    port, ref = out["port"], out["jax"]
    p_scores, r_scores = port.pop("scores"), ref.pop("scores")
    assert len(p_scores) == len(r_scores) > 0
    for p, r in zip(p_scores, r_scores):
        np.testing.assert_allclose(p, r, rtol=0, atol=TOL)
    assert port == ref
    served = [r for r in port["state"]["completed"] if r[-1] != "rejected"]
    assert 0 < len(served) < 10 and len(port["responses"]) == len(served)
    tenants = [r[REQUEST_FIELDS.index("tenant")] for r in served]
    assert set(tenants) == {"a", "b"}
    for (_, _, _, _, _, ctx), t in zip(port["responses"], tenants):
        assert all(c in sets["port"][t].texts for c in ctx)
    # run() keeps serving tenant-tagged requests through admission
    sched = scheduler.RequestScheduler(
        admission=scheduler.TokenBucketAdmission(rate_per_s=1.0))
    for i, tenant in enumerate(["", "a", "", "b"]):
        sched.submit(0.1 * (3 - i), query=f"q{i}",
                     query_emb=np.zeros(4, np.float32), tenant=tenant)
    done = sched.run(lambda req: 0.01)
    assert [r.tenant for r in done] == ["b", "", "a", ""]


# ----------------------------------------------------------------------
# examples/torch_edge_serving.py
# ----------------------------------------------------------------------
def test_torch_edge_serving_example(capsys):
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_edge_serving.py"
    spec = importlib.util.spec_from_file_location("torch_edge_serving", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    done = example.main(["--records", "300", "--requests", "6",
                         "--device", "cpu"])
    assert sorted(r.rid for r in done) == list(range(6))
    assert all(r.finish_s > r.start_s >= r.arrival_s and not r.failed
               for r in done)
    assert "[serve] 6 requests on cpu" in capsys.readouterr().out


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_run_pipelined_matches_the_cpu(cuda, batcher_params):
    """``run_pipelined`` over a card index (K1 in every S1, K2 in every S3)
    and a 2-layer card batcher (K5 causal, K6), against the same on the
    CPU: ids equal outside near-ties (an id may swap with a neighbour whose
    CPU score lies within 2 x ``TOL``), every count of the trace and every
    outcome equal, and the stamps and modeled seconds within 1e-9 where no
    swap changed a prompt."""
    _, (cfg, params) = batcher_params
    runs = []
    for device in (cuda, "cpu"):
        _, (ds, er) = _pipelined_pair(device)
        batcher = ContinuousBatcher(cfg, params.to(device), num_slots=2,
                                    max_len=48, device=device)
        pipe = StagedPipeline(RAGEngine(er, None, k=K, nprobe=NPROBE,
                                        max_new_tokens=6,
                                        maintenance_owner="external"),
                              ds.get_chunks, batcher=batcher)
        sched = scheduler.RequestScheduler()
        _submit_eight(sched, ds)
        scores = _scores(er)
        sched.run_pipelined(pipe, batch_size=3)
        runs.append((sched, scores))
    (card, _), (cpu, vals) = runs
    swapped = False
    for qi, (a, b) in enumerate(zip(card.pipeline_responses,
                                    cpu.pipeline_responses)):
        v = vals[qi // 3][qi % 3]
        for lane in np.nonzero(np.array(a.chunk_ids)
                               != np.array(b.chunk_ids))[0]:
            swapped = True
            assert any(abs(v[lane] - v[j]) <= 2 * TOL
                       for j in (lane - 1, lane + 1) if 0 <= j < len(v))
    counts = ("n_fired", "maintenance_ops", "checkpoints", "max_queue_depth")
    for s, st in card.pipeline_trace.stages.items():
        assert [getattr(st, c) for c in counts] == [
            getattr(cpu.pipeline_trace.stages[s], c) for c in counts], s
    assert card.outcome_counts() == cpu.outcome_counts()
    if not swapped:
        for a, b in zip(card.completed, cpu.completed):
            for x, y in ((a.start_s, b.start_s), (a.finish_s, b.finish_s)):
                assert abs(x - y) <= 1e-9 * max(abs(x), abs(y))
