"""The port's multi-tenant router (``repro_torch.core.tenant``) against the
JAX package's, case by case as in ``tests/test_tenant.py`` (its admission
cases are held in ``tests/test_torch_scheduler.py``).

Three tenants of ``generate_dataset(n_records=360, dim=32, n_topics=8,
n_queries=6, seed=40 + t)``, nlist 10, k 5, nprobe 3.  Each JAX tenant is
built by the JAX package and its centroids and assignment are loaded into
the port's tenant (``index_state_from_numpy``): two k-means runs are never
compared.  Held:

* inside the port, bitwise: a one-tenant router equals a standalone index
  (ids, scores, every modeled ``LatencyBreakdown`` field, the Alg. 3
  threshold, the hit rate, the resident bytes), and a mixed batch equals
  each tenant's queries served by its own index;
* against the JAX router, for fp32, fp16, int8 and pq (pq on the JAX
  codebook): scores within ``TOL``, ids equal outside near-ties (an id may
  swap only with a neighbour whose score lies within 2 x ``TOL``), every
  modeled field and the ``stats()`` of the shared substrate equal (they
  come from the same formulas on the same decisions).  The reference's own
  fused-equals-silos claim is not relied on: its CPU matmul's scores
  depend on the batch's shape.

Tolerance: fp32 scores of unit vectors in D = 32 summed in two orders
differ by at most 2 * 32 * 2**-24 * sum|q_i e_i| <= 4e-6 (``TOL``), as in
``tests/test_torch_edgerag.py``; the quantized tiers score the same
decoded values in both packages, so the same bound holds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EdgeCostModel as JaxCost  # noqa: E402
from repro.core import TenantRouter as JaxRouter  # noqa: E402
from repro.data import generate_dataset as jax_dataset  # noqa: E402
from repro.serving.engine import RAGEngine as JaxEngine  # noqa: E402
from repro.serving.pipeline import PipelineBatch as JaxBatch  # noqa: E402
from repro.serving.pipeline import StagedPipeline as JaxPipeline  # noqa: E402
from repro.serving.scheduler import (  # noqa: E402
    RequestScheduler as JaxScheduler)
from repro_torch.convert import (index_state_from_numpy,  # noqa: E402
                                 pq_codebook_from_numpy)
from repro_torch.core import (EdgeCostModel, EdgeRAGIndex,  # noqa: E402
                              TenantRouter)
from repro_torch.core.maintenance import FairShareMaintenance  # noqa: E402
from repro_torch.core.storage import (StorageBackend,  # noqa: E402
                                      TenantStorageView)
from repro_torch.data import TableEmbedder, generate_dataset  # noqa: E402
from repro_torch.serving import (PipelineBatch, RAGEngine,  # noqa: E402
                                 RequestScheduler, StagedPipeline)

DIM, K, NPROBE, NLIST = 32, 5, 3, 10
CACHE = 1 << 20
SLO_S = 0.002
TOL = 4e-6


def _data(t):
    return dict(n_records=360, dim=DIM, n_topics=8, n_queries=6,
                seed=40 + t)


@pytest.fixture(scope="module")
def corpora():
    """(JAX dataset, port dataset) per tenant; the cases that register new
    chunks make their own."""
    return [(jax_dataset(**_data(t)), generate_dataset(**_data(t)))
            for t in range(3)]


def _routers(corpora, *, slo_s=SLO_S, codec="fp32", mode="memory",
             root=None, budget=None, nlist=NLIST, tenant_slo=None):
    """(JAX router, port router on the CPU) over ``corpora``: each tenant
    built by the JAX package and its clustering loaded into the port; under
    pq the JAX codebook (trained by the first tenant's build) is installed
    once in the port's shared backend."""
    kw = dict(slo_s=slo_s, cache_bytes=CACHE, storage_codec=codec,
              storage_mode=mode, storage_budget_bytes=budget)
    jr = JaxRouter(DIM, JaxCost(), storage_root=root and f"{root}/jax", **kw)
    pr = TenantRouter(DIM, EdgeCostModel(),
                      storage_root=root and f"{root}/port", device="cpu",
                      **kw)
    for t, (jds, ds) in enumerate(corpora):
        tkw = {} if tenant_slo is None else {"slo_s": tenant_slo}
        jix = jr.create_tenant(f"t{t}", jds.embedder, jds.get_chunks, **tkw)
        assign = jix.build(jds.chunk_ids, jds.texts, nlist=nlist,
                           embeddings=jds.embeddings, seed=1)
        if codec == "pq" and t == 0:
            cb = jr.storage.pq
            pr.storage.install_pq(pq_codebook_from_numpy(
                np.asarray(cb.codebooks), cb.dim, cb.version))
        pix = pr.create_tenant(f"t{t}", ds.embedder, ds.get_chunks, **tkw)
        index_state_from_numpy(pix, jix.centroids, assign, ds.chunk_ids,
                               ds.texts, ds.embeddings)
        assert [c.stored for c in pix.clusters] == \
            [c.stored for c in jix.clusters]
    return jr, pr


def _assign(ix, n):
    """The per-chunk cluster assignment of ``ix`` (chunk ids 0..n-1)."""
    assign = np.empty(n, np.int64)
    for cid, cl in enumerate(ix.clusters):
        assign[cl.ids] = cid
    return assign


def _standalone(router, t, ds, *, device="cpu"):
    """A standalone port index on the clustering of ``router``'s tenant."""
    tix = router.tenant(t)
    ix = EdgeRAGIndex(DIM, ds.embedder, ds.get_chunks, EdgeCostModel(),
                      slo_s=tix.slo_s, cache_bytes=CACHE,
                      maintenance="deferred", device=device)
    index_state_from_numpy(ix, tix.centroids, _assign(tix, ds.n),
                           ds.chunk_ids, ds.texts, ds.embeddings)
    return ix


def _lat(lat):
    d = dataclasses.asdict(lat)
    d.pop("wall_s")
    return d


def _assert_near(p_ids, p_vals, r_ids, r_vals):
    """Scores within TOL; an id may differ only beside a score within
    2 x TOL."""
    r_ids, r_vals = np.asarray(r_ids), np.asarray(r_vals)
    np.testing.assert_allclose(p_vals, r_vals, rtol=0, atol=TOL)
    for qi, lane in zip(*np.nonzero(np.asarray(p_ids) != r_ids)):
        v = p_vals[qi]
        assert any(abs(v[lane] - v[j]) <= 2 * TOL
                   for j in (lane - 1, lane + 1) if 0 <= j < len(v)), \
            (qi, lane)


def _assert_equal_to_jax(p, r):
    (p_ids, p_vals, p_lats), (r_ids, r_vals, r_lats) = p, r
    _assert_near(p_ids, p_vals, r_ids, r_vals)
    assert [_lat(x) for x in p_lats] == [_lat(x) for x in r_lats]


def _mixed(corpora, n=4):
    """Interleaved batch t0 q0, t1 q0, t2 q0, t0 q1, ...: (tenants, JAX
    rows, port rows, (tenant, local query) per row)."""
    tenants, jembs, embs, local = [], [], [], []
    for qi in range(n):
        for t, (jds, ds) in enumerate(corpora):
            tenants.append(f"t{t}")
            jembs.append(jds.query_embs[qi])
            embs.append(ds.query_embs[qi])
            local.append((t, qi))
    return tenants, np.stack(jembs), np.stack(embs), local


# ----------------------------------------------------------------------
# bit-identity inside the port, parity with the JAX router
# ----------------------------------------------------------------------
def test_one_tenant_router_matches_standalone(corpora):
    """Same kernel calls, same cache / threshold mutations, same modeled
    charges — cold AND warm passes; the router also equals the JAX
    package's."""
    jds, ds = corpora[0]
    jr, pr = _routers(corpora[:1])
    sa = _standalone(pr, "t0", ds)
    tix = pr.tenant("t0")
    qc = [int(c) for c in ds.query_chars]
    for _ in range(3):
        ids0, vals0, lats0 = sa.search_batch(ds.query_embs, K, NPROBE, qc)
        got = pr.search_batch(ds.query_embs, K, NPROBE, qc, tenants="t0")
        ids1, vals1, lats1 = got
        assert np.array_equal(ids0, ids1) and np.array_equal(vals0, vals1)
        assert [_lat(x) for x in lats0] == [_lat(x) for x in lats1]
        _assert_equal_to_jax(got, jr.search_batch(
            jds.query_embs, K, NPROBE, qc, tenants="t0"))
    assert sa.threshold.threshold == tix.threshold.threshold
    assert sa.cache.hit_rate == tix.cache.hit_rate
    assert sa.memory_bytes() == pr.memory_bytes() == jr.memory_bytes()
    assert pr.stats() == jr.stats()


def test_mixed_batch_fused_matches_silos(corpora):
    """Interleaved 3-tenant batch through ONE fused slab launch == each
    tenant's queries through its own standalone port index, bitwise; and
    the JAX router's within TOL."""
    jr, pr = _routers(corpora)
    silos = [_standalone(pr, f"t{t}", ds)
             for t, (_, ds) in enumerate(corpora)]
    tenants, jembs, embs, local = _mixed(corpora)
    for _ in range(2):                      # cold + warm
        got = pr.search_batch(embs, K, NPROBE, tenants=tenants)
        mids, mvals, mlats = got
        refs = [silo.search_batch(ds.query_embs[:4], K, NPROBE)
                for silo, (_, ds) in zip(silos, corpora)]
        for gqi, (t, qi) in enumerate(local):
            assert np.array_equal(mids[gqi], refs[t][0][qi])
            assert np.array_equal(mvals[gqi], refs[t][1][qi])
            assert _lat(mlats[gqi])["n_clusters_probed"] == \
                _lat(refs[t][2][qi])["n_clusters_probed"]
        _assert_equal_to_jax(got, jr.search_batch(jembs, K, NPROBE,
                                                  tenants=tenants))
    assert pr.stats() == jr.stats()


def test_colliding_ids_score_only_own_rows(corpora):
    """Two tenants with the SAME chunk ids, texts and clustering (cluster
    and chunk 0 in both), tenant b's rows three times tenant a's: a query
    scoring a row of the other tenant would show a b-sized score.  Every
    query gets bitwise its own silo's ids and scores."""
    _, ds = corpora[0]
    jr, pr = _routers(corpora[:1])
    tix = pr.tenant("t0")
    b_rows = 3.0 * ds.embeddings
    b_embed = TableEmbedder(dict(zip(ds.chunk_ids.tolist(), b_rows)), DIM)
    bix = pr.create_tenant("b", b_embed.embed, ds.get_chunks)
    assign = _assign(tix, ds.n)
    index_state_from_numpy(bix, tix.centroids, assign, ds.chunk_ids,
                           ds.texts, b_rows)
    a_silo = _standalone(pr, "t0", ds)
    b_silo = EdgeRAGIndex(DIM, b_embed.embed, ds.get_chunks,
                          EdgeCostModel(), slo_s=SLO_S, cache_bytes=CACHE,
                          maintenance="deferred", device="cpu")
    index_state_from_numpy(b_silo, tix.centroids, assign, ds.chunk_ids,
                           ds.texts, b_rows)
    q = ds.query_embs
    tenants = ["t0", "b"] * len(q)
    embs = np.repeat(q, 2, axis=0)
    state = pr.search_begin(embs, K, NPROBE, tenants=tenants)
    assert ("t0", 0) in state.plan.owner and ("b", 0) in state.plan.owner
    pr.search_fetch(state)
    ids, vals, _ = pr.search_finish(state)
    a_ids, a_vals, _ = a_silo.search_batch(q, K, NPROBE)
    b_ids, b_vals, _ = b_silo.search_batch(q, K, NPROBE)
    assert np.array_equal(ids[0::2], a_ids)
    assert np.array_equal(vals[0::2], a_vals)
    assert np.array_equal(ids[1::2], b_ids)
    assert np.array_equal(vals[1::2], b_vals)
    # the two tenants' rows really are told apart by their scores
    assert (vals[1::2][:, 0] > 2.5 * vals[0::2][:, 0]).all()


def test_cross_tenant_plan_keys_are_tenant_scoped(corpora):
    _, pr = _routers(corpora)
    state = pr.search_begin(
        np.stack([corpora[0][1].query_embs[0], corpora[1][1].query_embs[0]]),
        K, NPROBE, tenants=["t0", "t1"])
    assert all(isinstance(k, tuple) and k[0] in ("t0", "t1")
               for k in state.plan.owner)
    for qi, probed in enumerate(state.plan.probed_per_q):
        assert all(key[0] == state.tenants[qi] for key in probed)
    assert state.centroid_total_s == sum(
        st.lats[0].centroid_search_s for st in state.states.values())


@pytest.mark.parametrize("codec,mode", [("fp16", "memory"),
                                        ("int8", "memory"),
                                        ("pq", "memory"), ("pq", "memmap")])
def test_quantized_router_matches_jax(corpora, codec, mode, tmp_path):
    """fp16 / int8 / pq routers (pq on the JAX codebook, shared by every
    tenant) against the JAX router: two passes of the mixed batch."""
    jr, pr = _routers(corpora, codec=codec, mode=mode,
                      root=str(tmp_path) if mode != "memory" else None)
    assert sum(c.stored for ix in pr.tenants.values()
               for c in ix.clusters) > 0
    if codec == "pq":
        assert pr.storage.pq.version == 0
        assert all(ix.storage.pq is pr.storage.pq
                   for ix in pr.tenants.values())
    tenants, jembs, embs, _ = _mixed(corpora)
    for _ in range(2):
        _assert_equal_to_jax(
            pr.search_batch(embs, K, NPROBE, tenants=tenants),
            jr.search_batch(jembs, K, NPROBE, tenants=tenants))
    assert pr.stats() == jr.stats()


# ----------------------------------------------------------------------
# shared-substrate isolation
# ----------------------------------------------------------------------
def test_storage_isolation_and_budget(corpora):
    # slo_s=0 forces every cluster heavy => everything goes to storage
    jr, pr = _routers(corpora[:2], slo_s=0.0, tenant_slo=0.0, nlist=8)
    b0 = pr.storage.tenant_bytes("t0")
    b1 = pr.storage.tenant_bytes("t1")
    assert b0 > 0 and b1 > 0
    assert pr.storage.total_bytes() == b0 + b1 == jr.storage.total_bytes()
    assert pr.tenant("t0").storage.total_bytes() == b0
    # clearing one tenant's view must not touch the other's blobs
    pr.tenant("t0").storage.clear()
    assert pr.storage.tenant_bytes("t0") == 0
    assert pr.storage.tenant_bytes("t1") == b1


def test_shared_budget_refuses_puts_across_tenants(corpora):
    """A budget under both tenants' stored bytes: the second tenant's
    later puts are refused, exactly where the JAX router refuses them,
    and the per-tenant bytes still sum to the total."""
    _, full = _routers(corpora[:2], slo_s=0.0, tenant_slo=0.0, nlist=8)
    budget = int(0.75 * full.storage.total_bytes())
    jr, pr = _routers(corpora[:2], slo_s=0.0, tenant_slo=0.0, nlist=8,
                      budget=budget)
    st = pr.stats()["storage"]
    assert st["put_rejected"] > 0 and st["total_bytes"] <= budget
    assert sum(st["per_tenant"].values()) == st["total_bytes"]
    assert st == jr.stats()["storage"]
    for t in ("t0", "t1"):
        assert [c.stored for c in pr.tenant(t).clusters] == \
            [c.stored for c in jr.tenant(t).clusters]


def test_shared_cache_per_tenant_accounting(corpora):
    # high SLO: no cluster is stored, every miss regenerates + caches
    jr, pr = _routers(corpora[:2], slo_s=10.0)
    for _ in range(2):
        for t, (jds, ds) in enumerate(corpora[:2]):
            _assert_equal_to_jax(
                pr.search_batch(ds.query_embs, K, NPROBE, tenants=f"t{t}"),
                jr.search_batch(jds.query_embs, K, NPROBE, tenants=f"t{t}"))
    pt = pr.cache.per_tenant
    for t in ("t0", "t1"):
        view = pr.tenant(t).cache
        assert view.hits == pt[t]["hits"] and view.misses == pt[t]["misses"]
    assert pr.cache.hits == sum(st["hits"] for st in pt.values())
    assert pr.cache.total_bytes() == sum(st["bytes"] for st in pt.values())
    assert pt == jr.cache.per_tenant


def test_bad_tenant_ids_and_unported_routes(corpora, tmp_path):
    _, ds = corpora[0]
    router = TenantRouter(DIM, EdgeCostModel(), device="cpu")
    router.create_tenant("a", ds.embedder, ds.get_chunks)
    with pytest.raises(AssertionError):
        router.create_tenant("a", ds.embedder, ds.get_chunks)
    with pytest.raises(AssertionError):
        router.create_tenant("bad/id", ds.embedder, ds.get_chunks)
    with pytest.raises(AssertionError):
        router.search_begin(ds.query_embs[:1], K, NPROBE, tenants=["nope"])
    with pytest.raises(NotImplementedError):
        router.search_begin(ds.query_embs[:1], K, NPROBE, tenants="a",
                            mesh=object())
    # durability needs a filesystem root: the memory-mode router has none
    # of its own, and takes one given; a tenant created later attaches too
    with pytest.raises(ValueError, match="filesystem root"):
        router.enable_durability()
    handles = router.enable_durability(str(tmp_path), checkpoint_every=4)
    assert list(handles) == ["a"]
    assert router.tenant("a").durability is handles["a"]
    assert handles["a"].dir == str(tmp_path / "durability" / "tenant_a")
    assert handles["a"].checkpoint_every == 4
    assert handles["a"].snapshots_total == 0        # "a" is not built yet
    b = router.create_tenant("b", ds.embedder, ds.get_chunks)
    assert b.durability is not None and b.durability.tenant == "b"


def test_storage_on_another_device_is_refused(corpora):
    """An index handed a storage backend of another device raises; the
    router's views carry the router's device."""
    _, ds = corpora[0]
    for dev in ("cuda", None):              # None means the card
        with pytest.raises(ValueError, match="storage on cuda"):
            EdgeRAGIndex(DIM, ds.embedder, ds.get_chunks, device="cpu",
                         storage=TenantStorageView(
                             StorageBackend(device=dev), "a"))
    router = TenantRouter(DIM, EdgeCostModel(), device="cpu")
    ix = router.create_tenant("a", ds.embedder, ds.get_chunks)
    assert ix.device == ix.storage.device == router.device \
        == torch.device("cpu")


def test_router_maintenance_is_fair_share():
    """An online insert enqueues deferred work under its tenant; the
    router's drain runs it, as in the JAX router."""
    corpora = [(jax_dataset(**_data(t)), generate_dataset(**_data(t)))
               for t in range(2)]
    jr, pr = _routers(corpora)
    assert isinstance(pr.maintenance, FairShareMaintenance)
    text = "doc-10000 " + "tok " * 20
    rng = np.random.default_rng(7)
    emb = rng.standard_normal(DIM).astype(np.float32)
    emb /= np.linalg.norm(emb)
    for router, ds in ((jr, corpora[0][0]), (pr, corpora[0][1])):
        ds.add_chunk(10_000, text, emb)
        n0 = len(router.maintenance)
        router.tenant("t0").insert(10_000, text)
        assert len(router.maintenance) >= n0
    assert [(t, op.kind, op.cid) for t, op in pr.maintenance.pending] == \
        [(t, op.kind, op.cid) for t, op in jr.maintenance.pending]
    report = pr.maintenance.drain(None)
    assert report.executed == jr.maintenance.drain(None).executed
    assert len(pr.maintenance) == 0
    assert pr.maintenance.stats() == jr.maintenance.stats()


# ----------------------------------------------------------------------
# serving integration
# ----------------------------------------------------------------------
def _scores(router):
    """Keeps the scores of every ``search_finish`` call of ``router``."""
    vals, finish = [], router.search_finish

    def logged(state):
        out = finish(state)
        vals.append(np.asarray(out[1]))
        return out
    router.search_finish = logged
    return vals


def _assert_responses_near(p_resp, r_resp, p_vals):
    for pb, rb, vals in zip(p_resp, r_resp, p_vals):
        assert len(pb) == len(rb)
        _assert_near(np.array([r.chunk_ids for r in pb]), vals,
                     np.array([r.chunk_ids for r in rb]), vals)
        for a, b in zip(pb, rb):
            assert (a.outcome, a.ttft_edge_s, a.prefill_edge_s) == \
                (b.outcome, b.ttft_edge_s, b.prefill_edge_s)
            assert _lat(a.retrieval) == _lat(b.retrieval)


def test_router_through_engine_and_pipeline(corpora):
    jr, pr = _routers(corpora)
    p_vals = _scores(pr)
    tenants = ["t0", "t1", "t2", "t0"]
    picks = [(0, 0), (1, 0), (2, 0), (0, 1)]
    out = []
    for side, router, Engine, Batch, Pipeline in (
            (0, jr, JaxEngine, JaxBatch, JaxPipeline),
            (1, pr, RAGEngine, PipelineBatch, StagedPipeline)):
        embs = np.stack([corpora[t][side].query_embs[q] for t, q in picks])
        eng = Engine(router, None, cost_model=router.cost, k=K,
                     nprobe=NPROBE, maintenance_owner="external")
        resp = eng.answer_batch(["q"] * 4, embs, tenants=tenants)
        # contexts come from each query's own tenant corpus
        for r, t in zip(resp, tenants):
            assert all(c in corpora[int(t[1])][side].texts
                       for c in r.context)
        one = eng.answer("q", embs[1], tenant="t1")
        responses, trace = Pipeline(eng, None).run([
            Batch(queries=["q"] * 4, query_embs=embs, arrival_s=0.0,
                  tenants=tenants),
            Batch(queries=["q"] * 4, query_embs=embs, arrival_s=1e-4,
                  tenants=list(reversed(tenants)))])
        assert trace.stages["s4"].n_fired == 2
        out.append(([resp, [one]] + responses, trace))
    (r_resp, r_trace), (p_resp, p_trace) = out
    _assert_responses_near(p_resp, r_resp, p_vals)
    assert p_trace.as_dict() == r_trace.as_dict()


def test_engine_drains_router_maintenance():
    """Deferred work queued by a tenant's online insert drains through the
    router's ``FairShareMaintenance`` after an engine batch (the engine
    owns draining), as in the JAX package: the same ops, the same modeled
    seconds."""
    corpora = [(jax_dataset(**_data(t)), generate_dataset(**_data(t)))
               for t in range(2)]
    jr, pr = _routers(corpora)
    p_vals = _scores(pr)
    text = "doc-10000 " + "tok " * 400
    emb = corpora[1][1].embeddings[3]
    out = []
    for side, router, Engine in ((0, jr, JaxEngine), (1, pr, RAGEngine)):
        corpora[1][side].add_chunk(10_000, text, emb)
        router.tenant("t1").insert(10_000, text, emb)
        assert len(router.maintenance) > 0
        eng = Engine(router, None, cost_model=router.cost, k=K,
                     nprobe=NPROBE)
        embs = np.stack([corpora[t][side].query_embs[q]
                         for t, q in ((1, 0), (0, 0), (1, 1))])
        resp = eng.answer_batch(["q"] * 3, embs, tenants=["t1", "t0", "t1"])
        assert len(router.maintenance) == 0
        out.append((resp, router.maintenance.stats()))
    (r_resp, r_st), (p_resp, p_st) = out
    _assert_responses_near([p_resp], [r_resp], p_vals)
    assert [r.maintenance_s for r in p_resp] == \
        [r.maintenance_s for r in r_resp]
    assert p_resp[0].maintenance_s > 0 and p_st == r_st


def test_run_pipelined_threads_tenants():
    """Tenant-tagged requests through ``run_pipelined``: outcomes, every
    stamp, the trace and the responses equal the JAX scheduler's."""
    corpora = [(jax_dataset(**_data(t)), generate_dataset(**_data(t)))
               for t in range(2)]
    jr, pr = _routers(corpora)
    p_vals = _scores(pr)
    out = []
    for side, router, Engine, Pipeline, Sched in (
            (0, jr, JaxEngine, JaxPipeline, JaxScheduler),
            (1, pr, RAGEngine, StagedPipeline, RequestScheduler)):
        eng = Engine(router, None, cost_model=router.cost, k=K,
                     nprobe=NPROBE, maintenance_owner="external")
        sched = Sched()
        for i in range(8):
            ds = corpora[i % 2][side]
            sched.submit(i * 1e-3, query="q", query_emb=ds.query_embs[i % 4],
                         slo_s=100.0, tenant=f"t{i % 2}")
        done = sched.run_pipelined(Pipeline(eng, None), batch_size=4)
        assert len(done) == 8 and all(r.outcome == "met" for r in done)
        out.append(sched)
    js, ps = out
    assert [(r.rid, r.tenant, r.outcome, r.start_s, r.finish_s)
            for r in ps.completed] == \
        [(r.rid, r.tenant, r.outcome, r.start_s, r.finish_s)
         for r in js.completed]
    assert ps.pipeline_trace.as_dict() == js.pipeline_trace.as_dict()
    _assert_responses_near(
        [ps.pipeline_responses[:4], ps.pipeline_responses[4:]],
        [js.pipeline_responses[:4], js.pipeline_responses[4:]], p_vals)


def test_router_stats_shape(corpora):
    jr, pr = _routers(corpora[:2])
    for router, side in ((jr, 0), (pr, 1)):
        router.search_batch(corpora[0][side].query_embs[:2], K, NPROBE,
                            tenants="t0")
    st = pr.stats()
    assert st["n_tenants"] == 2
    assert set(st["tenants"]) == {"t0", "t1"}
    assert st["cache"]["capacity_bytes"] == CACHE
    assert "t0" in st["storage"]["per_tenant"]
    assert st["memory_bytes"] == pr.memory_bytes()
    assert pr.stats() == jr.stats()


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_router_matches_the_cpu(cuda, corpora):
    """A mixed 3-tenant batch on a card router (one K1 launch a tenant,
    one fp32 K2 launch a batch) against the CPU router on the same
    clustering: ids outside near-ties, scores within TOL, every modeled
    field equal; and bitwise the card's own silos."""
    from repro_torch.kernels.ivf_topk import topk_ip
    from repro_torch.kernels.slab_topk import slab_topk
    _, cpu = _routers(corpora)
    card = TenantRouter(DIM, EdgeCostModel(), slo_s=SLO_S, cache_bytes=CACHE,
                        device=cuda)
    for t, (_, ds) in enumerate(corpora):
        src = cpu.tenant(f"t{t}")
        index_state_from_numpy(
            card.create_tenant(f"t{t}", ds.embedder, ds.get_chunks),
            src.centroids, _assign(src, ds.n), ds.chunk_ids, ds.texts,
            ds.embeddings)
    silos = [_standalone(card, f"t{t}", ds, device=cuda)
             for t, (_, ds) in enumerate(corpora)]
    tenants, _, embs, local = _mixed(corpora)
    for _ in range(2):
        k1, k2 = topk_ip.launches, slab_topk.launches_by_mode["fp32"]
        got = card.search_batch(embs, K, NPROBE, tenants=tenants)
        assert topk_ip.launches - k1 == 3
        assert slab_topk.launches_by_mode["fp32"] - k2 == 1
        _assert_equal_to_jax(got, cpu.search_batch(embs, K, NPROBE,
                                                   tenants=tenants))
        refs = [silo.search_batch(ds.query_embs[:4], K, NPROBE)
                for silo, (_, ds) in zip(silos, corpora)]
        for gqi, (t, qi) in enumerate(local):
            assert np.array_equal(got[0][gqi], refs[t][0][qi])
            assert np.array_equal(got[1][gqi], refs[t][1][qi])
    assert card.stats() == cpu.stats()
