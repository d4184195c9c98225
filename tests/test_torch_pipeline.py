"""The port's staged pipeline (``repro_torch.serving.pipeline``) against the
JAX package's, case by case as in ``tests/test_pipeline.py``.

Each case builds the JAX index at the JAX test's sizes (500 chunks, dim 32,
16 topics, nlist 16) and loads its centroids and assignment into the port
(``index_state_from_numpy``), applies the same seeded mutations to both and
runs the same batches through both pipelines.  Compared between the
packages: every response's chunk ids (exactly), its S3 scores (within
``TOL``), outcome, deadline, TTFT, queue wait, generated tokens and every
modeled ``LatencyBreakdown`` field; and ``PipelineTrace.as_dict()`` with
each stage's busy intervals, exactly (counts and modeled seconds come from
the same formulas on the same decisions in the same order, so the seconds
are equal to the last bit, not only within a tolerance).

Tolerance: fp32 scores of unit vectors in D = 32 summed in two orders: at
most 2 * 32 * 2**-24 * sum|q_i e_i| <= 4e-6 (``TOL``), as in
``tests/test_torch_online.py``.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import EdgeCostModel as JaxCost  # noqa: E402
from repro.core import EdgeRAGIndex as JaxIndex  # noqa: E402
from repro.core.faults import DegradationPolicy as JaxPolicy  # noqa: E402
from repro.data import generate_dataset as jax_dataset  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from repro.serving.engine import RAGEngine as JaxEngine  # noqa: E402
from repro.serving.pipeline import PipelineBatch as JaxBatch  # noqa: E402
from repro.serving.pipeline import StagedPipeline as JaxPipeline  # noqa: E402
from repro.serving.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (index_state_from_numpy,  # noqa: E402
                                 params_from_jax)
from repro_torch.core import EdgeCostModel, EdgeRAGIndex  # noqa: E402
from repro_torch.core.faults import DegradationPolicy  # noqa: E402
from repro_torch.data import generate_dataset  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatcher, PipelineBatch, RAGEngine, StagedPipeline)

DIM, K, NPROBE, NLIST = 32, 5, 5, 16
TOL = 4e-6
DATA = dict(n_records=500, dim=DIM, n_topics=16, n_queries=24, seed=5)
SLO_S = 0.15


class Side:
    """One package's half of a case: its dataset and the classes the case
    needs, so a case is written once and run on both packages."""

    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.ds = generate_dataset(**DATA) if port else jax_dataset(**DATA)
        self.Batch = PipelineBatch if port else JaxBatch
        self.Pipeline = StagedPipeline if port else JaxPipeline
        self.Engine = RAGEngine if port else JaxEngine
        self.Policy = DegradationPolicy if port else JaxPolicy


@pytest.fixture
def sides():
    """(JAX side, port side) on fresh datasets: cases register new chunks
    in them."""
    return Side("jax"), Side("port")


def _pair(sides, **kw):
    """(JAX index, port index) on the JAX build's clustering."""
    jax_side, port_side = sides
    kw.setdefault("slo_s", SLO_S)
    jds, ds = jax_side.ds, port_side.ds
    ref = JaxIndex(DIM, jds.embedder, jds.get_chunks, JaxCost(), **kw)
    assign = ref.build(jds.chunk_ids, jds.texts, nlist=NLIST,
                       embeddings=jds.embeddings, seed=1)
    port = EdgeRAGIndex(DIM, ds.embedder, ds.get_chunks, EdgeCostModel(),
                        device="cpu", **kw)
    index_state_from_numpy(port, ref.centroids, assign, ds.chunk_ids,
                           ds.texts, ds.embeddings)
    return ref, port


def _engine(side, index, **kw):
    kw.setdefault("k", K)
    kw.setdefault("nprobe", NPROBE)
    return side.Engine(index, None, **kw)


def _batches(side, n_batches, per_batch=4, arrivals=None):
    ds, out = side.ds, []
    for b in range(n_batches):
        qis = [(b * per_batch + i) % len(ds.query_embs)
               for i in range(per_batch)]
        out.append(side.Batch(
            queries=[f"q{qi}" for qi in qis],
            query_embs=np.stack([ds.query_embs[qi] for qi in qis]),
            arrival_s=0.0 if arrivals is None else arrivals[b]))
    return out


def _scores(index):
    """Keeps the scores of every ``search_finish`` call of ``index``."""
    vals = []
    finish = index.search_finish

    def logged(state):
        out = finish(state)
        vals.append(np.asarray(out[1]))
        return out
    index.search_finish = logged
    return vals


def _lat(lat):
    d = dataclasses.asdict(lat)
    d.pop("wall_s")
    return d


def _assert_responses_equal(port, ref):
    """Both packages' responses, batch by batch: every modeled field."""
    assert len(port) == len(ref)
    for pb, rb in zip(port, ref):
        assert len(pb) == len(rb)
        for a, b in zip(pb, rb):
            assert a.chunk_ids == b.chunk_ids
            assert a.output_tokens == b.output_tokens
            assert a.outcome == b.outcome
            assert a.deadline_s == b.deadline_s
            assert a.ttft_edge_s == b.ttft_edge_s
            assert a.prefill_edge_s == b.prefill_edge_s
            assert a.queue_wait_s == b.queue_wait_s
            assert a.maintenance_s == b.maintenance_s
            assert _lat(a.retrieval) == _lat(b.retrieval)


def _assert_scores_equal(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, rtol=0, atol=TOL)


def _assert_traces_equal(port, ref):
    assert port.as_dict() == ref.as_dict()
    for s, st in port.stages.items():
        assert st.intervals == ref.stages[s].intervals, s


def _run_both(sides, indexes, batches_of, **pipe_kw):
    """The same batches through both packages' pipelines over
    ``indexes`` (JAX, port); returns (port responses, port trace, JAX
    responses, JAX trace) after holding them equal."""
    engine_kw = pipe_kw.pop("engine_kw", {})
    out = []
    for side, index in zip(sides, indexes):
        scores = _scores(index)
        pipe = side.Pipeline(_engine(side, index, **engine_kw),
                             side.ds.get_chunks, **pipe_kw)
        responses, trace = pipe.run(batches_of(side))
        out.append((responses, trace, scores))
    (r_resp, r_trace, r_scores), (p_resp, p_trace, p_scores) = out
    _assert_responses_equal(p_resp, r_resp)
    _assert_scores_equal(p_scores, r_scores)
    _assert_traces_equal(p_trace, r_trace)
    return p_resp, p_trace, r_resp, r_trace


def _seed_maintenance(side, er, n=6, first_id=910_000):
    """Insert near-duplicates so deferred restores queue up (the index is
    built with a tight slo_s, so touched clusters go over it)."""
    ds = side.ds
    rng = np.random.default_rng(11)
    for j in range(n):
        nid = first_id + j
        emb = ds.embeddings[int(rng.integers(ds.n))] \
            + 0.03 * rng.standard_normal(DIM)
        emb = (emb / np.linalg.norm(emb)).astype(np.float32)
        text = f"doc-{nid} " + "tok " * 20
        ds.add_chunk(nid, text, emb)
        er.insert(nid, text)


def _offpath_targets(sides, batches_of, n=2):
    """Clusters no batch probes, from a scratch pair (both packages must
    name the same ones)."""
    targets = []
    for side, scratch in zip(sides, _pair(sides)):
        probed = set()
        for b in batches_of(side):
            probed |= set(scratch.plan_batch(b.query_embs, NPROBE).owner)
        targets.append([cid for cid in range(NLIST)
                        if cid not in probed][:n])
    assert targets[0] == targets[1] and targets[0], targets
    return targets[0]


def _rewrite(side, er, cid):
    """A long in-place rewrite of the cluster's first chunk: it pushes the
    cluster over the storage SLO, so ``update`` queues a restore."""
    chunk = int(er.clusters[cid].ids[0])
    text = f"doc-{chunk} rev " + "tok " * 1000
    side.ds.add_chunk(chunk, text, side.ds.embedder.table[chunk])
    er.update(chunk, text)


# ----------------------------------------------------------------------
# answers
# ----------------------------------------------------------------------
def test_pipeline_answers_match_sequential_and_jax(sides):
    p_resp, trace, _, _ = _run_both(
        sides, _pair(sides), lambda s: _batches(s, n_batches=3))
    port_side = sides[1]
    seq_eng = _engine(port_side, _pair(sides)[1])
    for b, resp_batch in zip(_batches(port_side, 3), p_resp):
        seq = seq_eng.answer_batch(b.queries, b.query_embs,
                                   port_side.ds.get_chunks)
        assert [r.chunk_ids for r in resp_batch] \
            == [r.chunk_ids for r in seq]
    assert trace.n_batches == 3
    assert trace.stages["s4"].busy_s > 0
    assert trace.stages["s2"].busy_s > 0
    assert trace.hidden_retrieval_fraction > 0


def test_empty_run(sides):
    jax_side, port_side = sides
    ref, port = _pair(sides)
    p_out, p_trace = StagedPipeline(_engine(port_side, port),
                                    port_side.ds.get_chunks).run([])
    r_out, r_trace = JaxPipeline(_engine(jax_side, ref),
                                 jax_side.ds.get_chunks).run([])
    assert p_out == r_out == []
    assert p_trace.n_batches == 0 and p_trace.n_queries == 0
    _assert_traces_equal(p_trace, r_trace)


# ----------------------------------------------------------------------
# maintenance in bubbles
# ----------------------------------------------------------------------
def _same_four(side):
    """The same 4 queries every batch: a narrow probe footprint leaves
    off-path clusters for the seeded restores to wait on."""
    one = _batches(side, n_batches=1)[0]
    return [side.Batch(queries=list(one.queries),
                       query_embs=one.query_embs.copy()) for _ in range(4)]


def test_maintenance_drains_in_bubbles_without_changing_answers(sides):
    # cache_bytes=0: every batch's fetch is real regeneration, so the S3
    # queue sees op-sized gaps
    kw = dict(maintenance="deferred", cache_bytes=0)
    pipes, seqs = _pair(sides, **kw), _pair(sides, **kw)
    targets = _offpath_targets(sides, _same_four)
    for side, pipe_er, seq_er in zip(sides, pipes, seqs):
        for cid in targets:
            _rewrite(side, pipe_er, cid)
            _rewrite(side, seq_er, cid)
        assert len(pipe_er.maintenance) > 0
    assert [(op.kind, op.cid) for op in pipes[1].maintenance.pending] \
        == [(op.kind, op.cid) for op in pipes[0].maintenance.pending]
    p_resp, trace, _, _ = _run_both(
        sides, pipes, _same_four,
        engine_kw={"maintenance_owner": "external"})
    port_er = pipes[1]
    assert trace.maintenance_in_bubbles_s > 0
    assert sum(s.maintenance_ops for s in trace.stages.values()) > 0
    assert len(port_er.maintenance) == 0
    for cid in targets:
        assert port_er.clusters[cid].storage_fresh
    port_side = sides[1]
    seq_eng = _engine(port_side, seqs[1])       # engine-owned drains
    for b, resp_batch in zip(_same_four(port_side), p_resp):
        seq = seq_eng.answer_batch(b.queries, b.query_embs,
                                   port_side.ds.get_chunks)
        assert [r.chunk_ids for r in resp_batch] \
            == [r.chunk_ids for r in seq]


def test_ramp_gap_is_not_a_bubble(sides):
    pair = _pair(sides, maintenance="deferred")
    for side, er in zip(sides, pair):
        _seed_maintenance(side, er, first_id=920_000)
        assert len(er.maintenance) > 0
    _, trace, _, _ = _run_both(
        sides, pair, lambda s: _batches(s, n_batches=1), final_drain=False,
        engine_kw={"maintenance_owner": "external"})
    assert trace.maintenance_in_bubbles_s == 0
    assert trace.stages["s2"].maintenance_ops == 0
    assert trace.stages["s3"].maintenance_ops == 0
    assert len(pair[1].maintenance) == len(pair[0].maintenance) > 0


# ----------------------------------------------------------------------
# stale-plan S3 re-entry
# ----------------------------------------------------------------------
def _mutate_after_first_fetch(side, er, eng, noise, mutated):
    """Wraps ``eng.stage_fetch``: after the first fetch, an in-place update
    of a chunk in a planned cluster bumps its content generation."""
    ds, fetch = side.ds, eng.stage_fetch

    def fetch_then_mutate(job, **kw):
        fetch(job, **kw)
        if side.name not in mutated:
            cid = next(iter(job.state.plan.owner))
            chunk_id = int(er.clusters[cid].ids[0])
            emb = ds.embedder.table[chunk_id] + noise
            emb = (emb / np.linalg.norm(emb)).astype(np.float32)
            text = f"doc-{chunk_id} rev tok tok tok"
            ds.add_chunk(chunk_id, text, emb)
            mutated[side.name] = (cid, chunk_id, text)
            er.update(chunk_id, text)
        return job
    eng.stage_fetch = fetch_then_mutate


def _stale_run(sides, max_replans):
    """One batch of 4 through both pipelines with the mutation in the
    S2->S3 window; returns (port responses, port trace, the mutation)."""
    noise = 0.02 * np.random.default_rng(13).standard_normal(DIM)
    mutated, out = {}, []
    for side, er in zip(sides, _pair(sides)):
        eng = _engine(side, er)
        _mutate_after_first_fetch(side, er, eng, noise, mutated)
        scores = _scores(er)
        pipe = side.Pipeline(eng, side.ds.get_chunks,
                             max_replans=max_replans)
        out.append(pipe.run([side.Batch(
            queries=[f"q{i}" for i in range(4)],
            query_embs=side.ds.query_embs[:4])]) + (scores,))
    assert mutated["port"] == mutated["jax"]
    (r_resp, r_trace, r_scores), (p_resp, p_trace, p_scores) = out
    _assert_responses_equal(p_resp, r_resp)
    _assert_scores_equal(p_scores, r_scores)
    _assert_traces_equal(p_trace, r_trace)
    return p_resp, p_trace, mutated["port"]


def _served_after(sides, mutation):
    """The port's sequential answers with the mutation applied before
    serving."""
    port_side = sides[1]
    ref = _pair(sides)[1]
    _, chunk_id, text = mutation
    ref.update(chunk_id, text)
    return _engine(port_side, ref).answer_batch(
        [f"q{i}" for i in range(4)], port_side.ds.query_embs[:4],
        port_side.ds.get_chunks)


def test_stale_plan_reenters_s1(sides):
    responses, trace, mutation = _stale_run(sides, max_replans=2)
    assert trace.replans == 1
    assert trace.stages["s1"].n_fired == 2
    seq = _served_after(sides, mutation)
    assert [r.chunk_ids for r in responses[0]] == [r.chunk_ids for r in seq]


def test_stale_plan_without_replans_regenerates(sides):
    """``max_replans=0``: the batch packs its stale plan and the resolver's
    regenerate-over-current-membership fallback answers it."""
    responses, trace, mutation = _stale_run(sides, max_replans=0)
    assert trace.replans == 0
    assert trace.stages["s1"].n_fired == 1
    seq = _served_after(sides, mutation)
    assert [r.chunk_ids for r in responses[0]] == [r.chunk_ids for r in seq]


def test_storage_tier_flip_does_not_replan(sides):
    seen = []
    for side, er in zip(sides, _pair(sides)):
        plan = er.plan_batch(side.ds.query_embs[:4], NPROBE)
        cid = next(iter(plan.owner))
        er._restore_cluster(cid)                     # tier flip only
        seen.append((cid, plan.fresh(cid, er.clusters[cid]),
                     er.resolver.stale_cids(plan)))
    assert seen[1] == seen[0]
    assert not seen[1][1]                 # the fetch-time guard trips...
    assert seen[1][2] == []               # ...but S3 does not


# ----------------------------------------------------------------------
# queue-wait deadline propagation
# ----------------------------------------------------------------------
def test_queue_wait_degrades_instead_of_silently_missing(sides):
    slo = 2.0

    def with_slo(n_batches):
        def batches_of(side):
            batches = _batches(side, n_batches=n_batches)
            batches[-1].slos = [slo] * len(batches[-1].queries)
            batches[-1].policy = side.Policy()
            return batches
        return batches_of

    alone = _run_both(sides, _pair(sides, cache_bytes=0),
                      with_slo(1))[0][-1]
    assert all(r.outcome == "ok" for r in alone)
    behind = _run_both(sides, _pair(sides, cache_bytes=0),
                       with_slo(4))[0][-1]
    assert all(r.outcome != "ok" for r in behind)
    assert any(r.outcome == "degraded" for r in behind)
    assert sum(r.retrieval.retrieval_s for r in behind) \
        < sum(a.retrieval.retrieval_s for a in alone)


def test_request_stamps(sides):
    """Requests attached to the batches are stamped with decode-stage
    entry, first token out and ``degraded``: the JAX scheduler's
    ``Request`` on one side, any object with those fields on the other
    (``tests/test_torch_scheduler.py`` holds the port's ``Request``).
    Batches as ``run_pipelined``
    groups 6 requests arriving 0.05 s apart, 3 a batch."""
    stamped, traces = [], []
    for side, er in zip(sides, _pair(sides)):
        ds, reqs = side.ds, []
        for i in range(6):
            kw = dict(arrival_s=0.05 * i, query=f"q{i}",
                      query_emb=ds.query_embs[i], slo_s=30.0)
            reqs.append(JaxRequest(rid=i, **kw) if side.name == "jax" else
                        types.SimpleNamespace(start_s=0.0, finish_s=0.0,
                                              degraded=False, **kw))
        batches = [side.Batch(queries=[r.query for r in g],
                              query_embs=[r.query_emb for r in g],
                              arrival_s=max(r.arrival_s for r in g),
                              slos=[r.slo_s for r in g], requests=g)
                   for g in (reqs[:3], reqs[3:])]
        traces.append(side.Pipeline(_engine(side, er),
                                    ds.get_chunks).run(batches)[1])
        stamped.append([(r.start_s, r.finish_s, r.degraded) for r in reqs])
    assert stamped[1] == stamped[0]
    _assert_traces_equal(traces[1], traces[0])
    for start, finish, _ in stamped[1]:
        assert finish > start >= 0.0
    assert stamped[1][3][0] > stamped[1][0][0]


# ----------------------------------------------------------------------
# drain ownership and the trace's schema
# ----------------------------------------------------------------------
def test_external_owner_engine_never_drains(sides):
    outs = []
    for side, er in zip(sides, _pair(sides, maintenance="deferred")):
        _seed_maintenance(side, er, first_id=930_000)
        depth = len(er.maintenance)
        assert depth > 0
        eng = _engine(side, er, maintenance_owner="external")
        out = eng.answer_batch(["q0", "q1"], side.ds.query_embs[:2],
                               side.ds.get_chunks)
        assert len(er.maintenance) == depth
        assert out[0].maintenance_s == 0.0
        outs.append(out)
    _assert_responses_equal([outs[1]], [outs[0]])


def test_pipeline_trace_as_dict_schema(sides):
    _, trace, _, r_trace = _run_both(sides, _pair(sides),
                                     lambda s: _batches(s, n_batches=2))
    d = trace.as_dict()
    assert list(d) == list(r_trace.as_dict())
    for key in ("n_batches", "n_queries", "makespan_s", "replans",
                "final_drain_s", "retrieval_busy_s", "decode_busy_s",
                "hidden_retrieval_s", "hidden_retrieval_fraction",
                "bubble_fraction", "maintenance_in_bubbles_s", "stages"):
        assert key in d, key
    assert set(d["stages"]) == {"s1", "s2", "s3", "s4"}
    for cell in d["stages"].values():
        assert list(cell) == ["busy_s", "n_fired", "maintenance_s",
                              "maintenance_ops", "checkpoints",
                              "max_queue_depth"]
    assert 0.0 <= d["hidden_retrieval_fraction"] <= 1.0
    assert d["hidden_retrieval_fraction"] + d["bubble_fraction"] \
        == pytest.approx(1.0)


# ----------------------------------------------------------------------
# S4 through each package's ContinuousBatcher
# ----------------------------------------------------------------------
def test_pipeline_through_the_batcher_matches_jax(sides):
    """2 slots for batches of 4, so admission waits for a free slot; the
    port's generator holds the JAX generator's params (2 layers, d_model
    128), so the tokens must be equal too."""
    jcfg = jax_get_config("sheared-llama-2.7b").reduced(num_layers=2,
                                                         d_model=128)
    cfg = get_config("sheared-llama-2.7b").reduced(num_layers=2, d_model=128)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jb = JaxBatcher(jcfg, params, num_slots=2, max_len=48)
    pb = ContinuousBatcher(cfg, params_from_jax(
        jax.tree.map(np.asarray, params), cfg, device="cpu"),
        num_slots=2, max_len=48, device="cpu")
    out = []
    for side, er, b in zip(sides, _pair(sides), (jb, pb)):
        pipe = side.Pipeline(_engine(side, er, max_new_tokens=6),
                             side.ds.get_chunks, batcher=b)
        out.append(pipe.run(_batches(side, n_batches=3)))
    (r_resp, r_trace), (p_resp, p_trace) = out
    _assert_responses_equal(p_resp, r_resp)
    _assert_traces_equal(p_trace, r_trace)
    assert all(len(r.output_tokens) == 6 for b in p_resp for r in b)
    assert all(s.free for s in pb.slots)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_pipeline_matches_the_cpu(cuda, sides):
    """The bubble-maintenance case on a card index (K1 in every S1, K2 in
    every S3) against the port on the CPU: ids equal outside near-ties
    (an id may swap with a neighbour whose CPU score lies within 2 x
    ``TOL``) and every count of the trace equal."""
    jax_side, port_side = sides
    kw = dict(maintenance="deferred", cache_bytes=0, slo_s=SLO_S)
    jds, ds = jax_side.ds, port_side.ds
    ref = JaxIndex(DIM, jds.embedder, jds.get_chunks, JaxCost(), **kw)
    assign = ref.build(jds.chunk_ids, jds.texts, nlist=NLIST,
                       embeddings=jds.embeddings, seed=1)
    targets = _offpath_targets(sides, _same_four)
    runs = []
    for device in (cuda, "cpu"):
        er = EdgeRAGIndex(DIM, ds.embedder, ds.get_chunks, EdgeCostModel(),
                          device=device, **kw)
        index_state_from_numpy(er, ref.centroids, assign, ds.chunk_ids,
                               ds.texts, ds.embeddings)
        for cid in targets:
            _rewrite(port_side, er, cid)
        scores = _scores(er)
        pipe = StagedPipeline(_engine(port_side, er,
                                      maintenance_owner="external"),
                              ds.get_chunks)
        responses, trace = pipe.run(_same_four(port_side))
        assert len(er.maintenance) == 0
        runs.append((responses, trace, scores))
    (c_resp, c_trace, _), (p_resp, p_trace, p_scores) = runs
    assert c_trace.maintenance_in_bubbles_s > 0
    for cb, pb, vals in zip(c_resp, p_resp, p_scores):
        for qi, (a, b) in enumerate(zip(cb, pb)):
            for lane in np.nonzero(np.array(a.chunk_ids)
                                   != np.array(b.chunk_ids))[0]:
                v = vals[qi]
                assert any(abs(v[lane] - v[j]) <= 2 * TOL
                           for j in (lane - 1, lane + 1)
                           if 0 <= j < len(v)), (qi, lane)
    counts = ("n_fired", "maintenance_ops", "checkpoints", "max_queue_depth")
    assert c_trace.replans == p_trace.replans
    assert c_trace.n_batches == p_trace.n_batches
    for s in c_trace.stages:
        assert [getattr(c_trace.stages[s], c) for c in counts] \
            == [getattr(p_trace.stages[s], c) for c in counts], s
