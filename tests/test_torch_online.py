"""The port's online updates, fault handling, deadlines and prefetch against
the JAX package on a small corpus.

Both indexes start from the JAX index's centroids and assignment
(``index_state_from_numpy``), as in ``tests/test_torch_edgerag.py``.  Then
the same mutations (inserts that force splits, removes that force merges, an
update), the same seeded ``FaultInjector`` and the same deadlines must lead
both packages to the same decisions: cluster ids, stored / active flags,
generations, storage freshness and the maintenance queue after the updates,
and, per query, the same ids outside near-ties and every
``LatencyBreakdown`` field but ``wall_s`` equal (the modeled seconds come
from the same formulas on the same decisions).  ``RAGEngine.answer_batch``
with ``prefetch=True``, deadlines and a ``DegradationPolicy`` returns the
same chunk ids, outcomes and modeled charges.

Tolerance: fp32 scores of unit vectors in D = 32, two summation orders:
at most 2 * 32 * 2**-24 * sum|q_i e_i| <= 4e-6 (``TOL``), as in
``tests/test_torch_edgerag.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EdgeCostModel as JaxCost  # noqa: E402
from repro.core import EdgeRAGIndex as JaxIndex  # noqa: E402
from repro.core.faults import DegradationPolicy as JaxPolicy  # noqa: E402
from repro.core.faults import FaultInjector as JaxFaults  # noqa: E402
from repro.data import generate_dataset as jax_dataset  # noqa: E402
from repro.serving.engine import RAGEngine as JaxEngine  # noqa: E402
from repro_torch.convert import index_state_from_numpy  # noqa: E402
from repro_torch.core import EdgeCostModel, EdgeRAGIndex  # noqa: E402
from repro_torch.core.faults import DegradationPolicy, FaultInjector  # noqa: E402
from repro_torch.data import generate_dataset  # noqa: E402
from repro_torch.serving import RAGEngine  # noqa: E402

DIM, K, NPROBE = 32, 10, 5
TOL = 4e-6
DATA = dict(n_records=900, dim=DIM, n_topics=30, n_queries=64, seed=5)


def _pair(ds, jds, **kw):
    """(JAX index, port index) on the same clustering, store_heavy with a
    1 MB cache (the "edgerag" configuration), plus ``kw``."""
    kw = dict(store_heavy=True, cache_bytes=1 << 20, **kw)
    ref = JaxIndex(DIM, jds.embedder, jds.get_chunks, JaxCost(), slo_s=0.3,
                   **kw)
    assign = ref.build(jds.chunk_ids, jds.texts, nlist=30,
                       embeddings=jds.embeddings, seed=1)
    port = EdgeRAGIndex(DIM, ds.embedder, ds.get_chunks, EdgeCostModel(),
                        slo_s=0.3, device="cpu", **kw)
    index_state_from_numpy(port, ref.centroids, assign, ds.chunk_ids,
                           ds.texts, ds.embeddings)
    return ref, port


def _datasets():
    """Fresh datasets per test: the updates register new chunks in them."""
    return generate_dataset(**DATA), jax_dataset(**DATA)


def _cluster_state(ix):
    return [(c.ids.tolist(), c.stored, c.active, c.generation,
             c.storage_fresh) for c in ix.clusters]


def _lat(lat):
    d = dataclasses.asdict(lat)
    d.pop("wall_s")
    return d


def _assert_search_equal(r, p):
    """(ids, scores, lats) of both packages: scores within TOL, ids equal
    outside near-ties, every modeled field equal."""
    (r_ids, r_vals, r_lats), (p_ids, p_vals, p_lats) = r, p
    r_ids, r_vals = np.asarray(r_ids), np.asarray(r_vals)
    np.testing.assert_allclose(p_vals, r_vals, rtol=0, atol=TOL)
    for qi, lane in zip(*np.nonzero(p_ids != r_ids)):
        v = p_vals[qi]
        assert any(abs(v[lane] - v[j]) <= 2 * TOL
                   for j in (lane - 1, lane + 1) if 0 <= j < K), (qi, lane)
    assert [_lat(x) for x in p_lats] == [_lat(x) for x in r_lats]


def _churn(ref, port, ds, jds, rng, new_id, n_insert, n_remove):
    """The same inserts (long texts, so clusters split), removes (so
    clusters merge) and one update on both; returns the next free id."""
    for _ in range(n_insert):
        emb = ds.embeddings[int(rng.integers(ds.n))]
        text = f"doc-{new_id} " + "alpha " * 50
        ds.add_chunk(new_id, text, emb)
        jds.add_chunk(new_id, text, emb)
        assert port.insert(new_id, text, emb) == ref.insert(new_id, text, emb)
        new_id += 1
    live = sorted(port._chunk_cluster)
    for chunk in rng.choice(live, n_remove, replace=False):
        assert port.remove(int(chunk)) == ref.remove(int(chunk))
    chunk = int(sorted(port._chunk_cluster)[-1])
    text = ds.get_chunks([chunk])[0] + " more"
    assert port.update(chunk, text) == ref.update(chunk, text)
    return new_id


@pytest.mark.parametrize("maintenance", ["sync", "deferred"])
def test_online_updates_match_jax(maintenance):
    ds, jds = _datasets()
    ref, port = _pair(ds, jds, maintenance=maintenance)
    # clusters over 6,000 chars split and clusters under 28 chunks merge
    ref.split_max_chars = port.split_max_chars = 6000
    ref.merge_min_size = port.merge_min_size = 28
    _churn(ref, port, ds, jds, np.random.default_rng(0), 10_000, 25, 80)
    assert _cluster_state(port) == _cluster_state(ref)
    assert len(port.maintenance) == len(ref.maintenance)
    if maintenance == "deferred":
        assert len(port.maintenance) > 0
        assert [(op.kind, op.cid) for op in port.maintenance.pending] == \
            [(op.kind, op.cid) for op in ref.maintenance.pending]
        port.maintenance.drain()
        ref.maintenance.drain()
        assert _cluster_state(port) == _cluster_state(ref)
        assert len(port.maintenance) == len(ref.maintenance) == 0
    assert sum(not c.active for c in port.clusters) > 0        # merged
    assert len(port.clusters) > 30                              # split
    for start in (0, 16):
        q = ds.query_embs[start:start + 16]
        _assert_search_equal(ref.search_batch(q, K, NPROBE),
                             port.search_batch(q, K, NPROBE))
    assert port.stats() | {"memory_bytes": 0} == \
        ref.stats() | {"memory_bytes": 0}


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_search_batch_under_faults_and_deadlines_matches_jax(codec):
    ds, jds = _datasets()
    ref, port = _pair(ds, jds, storage_codec=codec)
    ref.storage.faults = JaxFaults(seed=3, fault_rate=0.3, stall_rate=0.2)
    port.storage.faults = FaultInjector(seed=3, fault_rate=0.3,
                                        stall_rate=0.2)
    outcomes = {"retries": 0, "degraded": 0}
    for start, budget in ((0, None), (16, 0.05), (32, 0.01)):
        q = ds.query_embs[start:start + 16]
        chars = ds.query_chars[start:start + 16].tolist()
        deadlines = [budget if i % 3 else None for i in range(16)]
        r = ref.search_batch(q, K, NPROBE, chars, deadlines=deadlines,
                             policy=JaxPolicy())
        p = port.search_batch(q, K, NPROBE, chars, deadlines=deadlines,
                              policy=DegradationPolicy())
        _assert_search_equal(r, p)
        outcomes["retries"] += sum(x.retries for x in p[2])
        outcomes["degraded"] += sum(x.degraded_clusters for x in p[2])
    assert outcomes["retries"] > 0 and outcomes["degraded"] > 0, outcomes
    assert port.storage.faults.injected_total == \
        ref.storage.faults.injected_total
    assert port.stats() | {"memory_bytes": 0} == \
        ref.stats() | {"memory_bytes": 0}


def test_answer_batch_prefetch_deadlines_policy_matches_jax():
    ds, jds = _datasets()
    ref_ix, port_ix = _pair(ds, jds)
    ref_ix.storage.faults = JaxFaults(seed=1, fault_rate=0.3, stall_rate=0.2)
    port_ix.storage.faults = FaultInjector(seed=1, fault_rate=0.3,
                                           stall_rate=0.2)
    ref = JaxEngine(ref_ix, None, k=K, nprobe=NPROBE)
    port = RAGEngine(port_ix, None, k=K, nprobe=NPROBE)
    rng = np.random.default_rng(4)
    new_id, outcomes, saved = 20_000, set(), 0.0
    for start in (0, 12, 24):
        queries = [f"query {qi}" for qi in range(start, start + 12)]
        embs = ds.query_embs[start:start + 12]
        deadlines = [None, 0.5, 0.08, 0.02] * 3
        r = ref.answer_batch(queries, embs, jds.get_chunks, prefetch=True,
                             deadlines=deadlines, policy=JaxPolicy())
        p = port.answer_batch(queries, embs, ds.get_chunks, prefetch=True,
                              deadlines=deadlines, policy=DegradationPolicy())
        for a, b in zip(p, r):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            for d in (da, db):
                for name in ("ttft_wall_s", "decode_wall_s"):
                    d.pop(name)
                d["retrieval"].pop("wall_s")
            assert da == db
            outcomes.add(a.outcome)
            saved += a.prefetch_saved_s
        new_id = _churn(ref_ix, port_ix, ds, jds, rng, new_id, 4, 10)
    assert {"ok", "degraded"} <= outcomes, outcomes
    assert saved > 0
