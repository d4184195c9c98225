"""The port's EdgeRAG index against the JAX package on a small corpus.

The port index is loaded with the JAX index's centroids and assignment
(``repro_torch.convert.index_state_from_numpy``): k-means argmin near-ties
make two separately trained indexes a bad comparison.  Then, under the three
Table-4 configurations, ``search_batch`` must return the same ids outside
near-ties and exactly equal ``LatencyBreakdown`` counts and modeled
seconds (they come from the same formulas on the same decisions).  Inside
the port, a batch equals its queries run one at a time, bitwise.

The same holds under the quantized storage codecs (``storage_codec=``
fp16 / int8 / pq, pq also in the memmap mode): the JAX index's PQ codebook
is carried across (``pq_codebook_from_numpy``), so both packages store and
score the same codes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EdgeCostModel as JaxCost  # noqa: E402
from repro.core import EdgeRAGIndex as JaxIndex  # noqa: E402
from repro.core.kmeans import kmeans as jax_kmeans  # noqa: E402
from repro.data import generate_dataset as jax_dataset  # noqa: E402
from repro_torch.convert import index_state_from_numpy  # noqa: E402
from repro_torch.convert import pq_codebook_from_numpy  # noqa: E402
from repro_torch.core import EdgeCostModel, EdgeRAGIndex  # noqa: E402
from repro_torch.core.kmeans import kmeans  # noqa: E402
from repro_torch.core.storage import StorageBackend  # noqa: E402
from repro_torch.data import generate_dataset  # noqa: E402

CONFIGS = {
    "embed_gen": dict(store_heavy=False, cache_bytes=0),
    "embed_gen_load": dict(store_heavy=True, cache_bytes=0),
    "edgerag": dict(store_heavy=True, cache_bytes=1 << 20),
}
DIM, K, NPROBE = 32, 10, 5
# fp32 scores of unit vectors in D=32: two summation orders differ by at
# most 2 * 32 * 2**-24 * sum|q_i e_i| <= 4e-6
TOL = 4e-6


@pytest.fixture(scope="module")
def ds():
    return generate_dataset(n_records=900, dim=DIM, n_topics=30,
                            n_queries=64, seed=5)


@pytest.fixture(scope="module")
def jds():
    return jax_dataset(n_records=900, dim=DIM, n_topics=30, n_queries=64,
                       seed=5)


def test_dataset_copy_matches_reference(ds, jds):
    assert ds.texts == jds.texts
    for name in ("chunk_ids", "embeddings", "query_embs", "query_chars",
                 "topic_of_chunk"):
        assert np.array_equal(getattr(ds, name), getattr(jds, name))
    probe = ds.texts[:5] + ["no oracle prefix here"]
    assert np.array_equal(ds.embedder(probe), jds.embedder(probe))


def _pair(ds, jds, cfg):
    ref = JaxIndex(DIM, jds.embedder, jds.get_chunks, JaxCost(), slo_s=0.3,
                   **CONFIGS[cfg])
    assign = ref.build(jds.chunk_ids, jds.texts, nlist=30,
                       embeddings=jds.embeddings, seed=1)
    port = EdgeRAGIndex(DIM, ds.embedder, ds.get_chunks, EdgeCostModel(),
                        slo_s=0.3, device="cpu", **CONFIGS[cfg])
    index_state_from_numpy(port, ref.centroids, assign, ds.chunk_ids,
                           ds.texts, ds.embeddings)
    return ref, port


def _lat_fields(lat):
    d = dataclasses.asdict(lat)
    d.pop("wall_s")
    return d


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_search_batch_matches_jax(ds, jds, cfg):
    ref, port = _pair(ds, jds, cfg)
    assert [c.stored for c in port.clusters] == [c.stored for c in ref.clusters]
    swaps = 0
    for start in range(0, 48, 16):
        q = ds.query_embs[start:start + 16]
        r_ids, r_vals, r_lats = ref.search_batch(q, K, NPROBE)
        p_ids, p_vals, p_lats = port.search_batch(q, K, NPROBE)
        np.testing.assert_allclose(p_vals, np.asarray(r_vals), rtol=0,
                                   atol=TOL)
        differ = p_ids != np.asarray(r_ids)
        # a swapped id must sit next to a score within the tolerance
        for qi, lane in zip(*np.nonzero(differ)):
            v = p_vals[qi]
            near = [abs(v[lane] - v[j]) <= 2 * TOL
                    for j in (lane - 1, lane + 1) if 0 <= j < K]
            assert any(near), (cfg, start + qi, lane)
            swaps += 1
        assert [_lat_fields(x) for x in p_lats] == \
            [_lat_fields(x) for x in r_lats]
    assert swaps <= 2
    assert port.stats() | {"memory_bytes": 0} == \
        ref.stats() | {"memory_bytes": 0}
    assert port.memory_bytes() == ref.memory_bytes()


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_search_batch_equals_sequential_bitwise(ds, jds, cfg):
    _, seq = _pair(ds, jds, cfg)
    _, bat = _pair(ds, jds, cfg)
    nq = 24
    s = [seq.search(ds.query_embs[qi], K, NPROBE) for qi in range(nq)]
    b_ids, b_vals, lats = bat.search_batch(ds.query_embs[:nq], K, NPROBE)
    assert np.array_equal(np.stack([x[0][0] for x in s]), b_ids)
    assert np.array_equal(np.stack([x[1][0] for x in s]), b_vals)
    assert sum(lat.n_shared_hits for lat in lats) > 0


def test_online_updates_keep_lookup_consistent(ds, jds):
    """insert / update / remove with split and merge run on the port and
    keep every live chunk retrievable through its cluster."""
    _, port = _pair(ds, jds, "edgerag")
    port.split_max_chars = 6000
    rng = np.random.default_rng(0)
    new_id = 10_000
    for i in range(20):
        emb = ds.embeddings[int(rng.integers(ds.n))]
        text = f"doc-{new_id} " + "alpha " * 50
        ds.add_chunk(new_id, text, emb)
        cid = port.insert(new_id, text, emb)
        assert new_id in port.clusters[cid].ids
        new_id += 1
    for chunk in rng.choice(ds.n, 60, replace=False):
        port.remove(int(chunk))
    port.update(int(ds.chunk_ids[-1]), ds.texts[-1] + " more")
    for chunk, cid in port._chunk_cluster.items():
        assert chunk in port.clusters[cid].ids and port.clusters[cid].active
    ids, _, _ = port.search_batch(ds.query_embs[:8], K, NPROBE)
    live = set(port._chunk_cluster)
    assert all(int(i) in live for i in ids.ravel() if i >= 0)


def test_kmeans_matches_jax_from_same_seeds():
    """Same k-means++ draws, same Lloyd steps: on well-separated data the
    assignments agree exactly and centroids within fp32 rounding."""
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((6, 16)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 6, 300)]
         + 0.1 * rng.standard_normal((300, 16))).astype(np.float32)
    c, a = kmeans(x, 6, iters=10, seed=3, device="cpu")
    jc, ja = jax_kmeans(x, 6, iters=10, seed=3)
    assert np.array_equal(a, np.asarray(ja))
    np.testing.assert_allclose(c, np.asarray(jc), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(codec="fp16"), dict(codec="int8"),
                                dict(codec="pq"), dict(mode="memmap")])
def test_storage_later_slices_raise(kw, tmp_path):
    """The codecs and the mode this test once saw refused now construct and
    round-trip; a misspelt codec or mode still raises."""
    if "mode" in kw:
        kw = dict(kw, root=str(tmp_path))
    st = StorageBackend(device="cpu", pq_m=4, **kw)
    emb = np.random.default_rng(0).standard_normal((9, 8)).astype(np.float32)
    assert st.put(2, emb) > 0 and st.payload_rows(st.get_many_raw([2])[0]) == 9
    atol = {"fp16": 1e-3, "int8": 2e-2}.get(kw.get("codec"), 0.0)
    np.testing.assert_allclose(st.get(2), emb, rtol=0, atol=atol)
    bad = {name: value + "x" for name, value in kw.items() if name != "root"}
    with pytest.raises(ValueError):
        StorageBackend(**bad)


@pytest.mark.parametrize("mode", ["memory", "disk"])
def test_storage_fp32_roundtrip_and_missing(mode, tmp_path):
    st = StorageBackend(mode, root=str(tmp_path) if mode == "disk" else None)
    emb = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    assert st.put(3, emb) > 0 and 3 in st
    assert np.array_equal(st.get(3), emb)
    out = st.get_many([3, 9])
    assert np.array_equal(out[0], emb) and out[1] is None
    st.delete(3)
    assert 3 not in st and st.total_bytes() == 0


# ---------------------------------------------------------------------------
# quantized storage tiers: fp16 / int8 / pq (memory and memmap)
# ---------------------------------------------------------------------------
TIERS = [("fp16", "memory"), ("int8", "memory"), ("pq", "memory"),
         ("pq", "memmap")]


def _codec_pair(ds, jds, codec, mode, tmp_path):
    roots = {}
    if mode != "memory":
        roots = {side: str(tmp_path / side) for side in ("jax", "port")}
    ref = JaxIndex(DIM, jds.embedder, jds.get_chunks, JaxCost(), slo_s=0.3,
                   storage_codec=codec, storage_mode=mode,
                   storage_root=roots.get("jax"), **CONFIGS["edgerag"])
    assign = ref.build(jds.chunk_ids, jds.texts, nlist=30,
                       embeddings=jds.embeddings, seed=1)
    port = EdgeRAGIndex(DIM, ds.embedder, ds.get_chunks, EdgeCostModel(),
                        slo_s=0.3, storage_codec=codec, storage_mode=mode,
                        storage_root=roots.get("port"), device="cpu",
                        **CONFIGS["edgerag"])
    cb = None
    if codec == "pq":
        jcb = ref.storage.pq
        cb = pq_codebook_from_numpy(np.asarray(jcb.codebooks), jcb.dim,
                                    jcb.version)
    index_state_from_numpy(port, ref.centroids, assign, ds.chunk_ids,
                           ds.texts, ds.embeddings, pq_codebook=cb)
    return ref, port


@pytest.mark.parametrize("codec,mode", TIERS)
def test_search_batch_matches_jax_under_codec(ds, jds, codec, mode,
                                              tmp_path):
    ref, port = _codec_pair(ds, jds, codec, mode, tmp_path)
    assert [c.stored for c in port.clusters] == [c.stored for c in ref.clusters]
    assert port.storage_bytes() == ref.storage_bytes()
    swaps, tiers = 0, {"n_storage_loads": 0, "n_cache_hits": 0,
                       "n_generated": 0}
    for start in range(0, 48, 16):
        q = ds.query_embs[start:start + 16]
        chars = ds.query_chars[start:start + 16].tolist()
        r_ids, r_vals, r_lats = ref.search_batch(q, K, NPROBE, chars)
        p_ids, p_vals, p_lats = port.search_batch(q, K, NPROBE, chars)
        # the stored scores of int8 rows carry one extra rounding (the
        # scale multiply) on each side: TOL still bounds the difference
        np.testing.assert_allclose(p_vals, np.asarray(r_vals), rtol=0,
                                   atol=TOL)
        differ = p_ids != np.asarray(r_ids)
        for qi, lane in zip(*np.nonzero(differ)):
            v = p_vals[qi]
            near = [abs(v[lane] - v[j]) <= 2 * TOL
                    for j in (lane - 1, lane + 1) if 0 <= j < K]
            assert any(near), (codec, start + qi, lane)
            swaps += 1
        # tier counts and every modeled second (fused dequant, PQ tables and
        # gathers included) are equal, not close
        assert [_lat_fields(x) for x in p_lats] == \
            [_lat_fields(x) for x in r_lats]
        for name in tiers:
            tiers[name] += sum(getattr(x, name) for x in p_lats)
    assert all(tiers.values()), tiers
    assert swaps <= 2
    lat = p_lats[0]
    if codec == "pq":
        assert lat.l2_pq_lut_s > 0
    assert port.stats() | {"memory_bytes": 0} == \
        ref.stats() | {"memory_bytes": 0}


@pytest.mark.parametrize("codec,mode", TIERS)
def test_codec_search_batch_equals_sequential_bitwise(ds, jds, codec, mode,
                                                      tmp_path):
    _, seq = _codec_pair(ds, jds, codec, mode, tmp_path / "seq")
    _, bat = _codec_pair(ds, jds, codec, mode, tmp_path / "bat")
    nq = 24
    s = [seq.search(ds.query_embs[qi], K, NPROBE) for qi in range(nq)]
    b_ids, b_vals, _ = bat.search_batch(ds.query_embs[:nq], K, NPROBE)
    assert np.array_equal(np.stack([x[0][0] for x in s]), b_ids)
    assert np.array_equal(np.stack([x[1][0] for x in s]), b_vals)


def _cbv(port, cid):
    raw = port.storage.get_many_raw([cid])[0]
    return int(np.asarray(raw["cbv"]).reshape(-1)[0])


@pytest.mark.parametrize("maintenance", ["sync", "deferred"])
def test_retrain_pq_reencodes_stored_clusters(ds, jds, maintenance,
                                              tmp_path):
    """``retrain_pq`` bumps the codebook version and re-encodes every stored
    cluster under it: at once (sync), or through queued restores, with any
    stored cluster a search needs before its restore regenerated and
    re-persisted on the way (deferred)."""
    _, port = _codec_pair(ds, jds, "pq", "memmap", tmp_path)
    port.maintenance_mode = maintenance
    stored = [c for c, cl in enumerate(port.clusters) if cl.stored]
    version = port.storage.pq.version
    port.retrain_pq(ds.embeddings, seed=7)
    assert port.storage.pq.version == version + 1
    if maintenance == "sync":
        assert all(port.clusters[c].storage_fresh for c in stored)
        assert all(_cbv(port, c) == version + 1 for c in stored)
        return
    assert len(port.maintenance) == len(stored)
    assert not any(port.clusters[c].storage_fresh for c in stored)
    _, _, lats = port.search_batch(ds.query_embs[:16], K, NPROBE)
    healed = [c for c in stored if port.clusters[c].storage_fresh]
    assert healed and sum(lat.n_generated for lat in lats) >= len(healed)
    assert all(_cbv(port, c) == version + 1 for c in healed)
    port.maintenance.drain(None)
    assert all(port.clusters[c].storage_fresh for c in stored)
    assert port.storage.io_stats["corrupt_dropped"] == 0


def test_stale_codebook_blob_is_quarantined_and_healed(ds, jds, tmp_path):
    """A codebook retrained behind the index's back leaves every stored
    blob stale: its first read quarantine-drops it without retries, the
    cluster is regenerated, and the self-heal re-persists it under the new
    version."""
    _, port = _codec_pair(ds, jds, "pq", "memmap", tmp_path)
    port.storage.train_pq(ds.embeddings, seed=3)
    version = port.storage.pq.version
    plan = port.plan_batch(ds.query_embs[:16], NPROBE)
    probed_stored = [c for c in plan.owner if port.clusters[c].stored]
    _, _, lats = port.search_batch(ds.query_embs[:16], K, NPROBE, plan=plan)
    io = port.storage.io_stats
    assert io["corrupt_dropped"] == len(probed_stored) > 0
    assert io["retries"] == 0
    assert sum(lat.n_generated for lat in lats) >= len(probed_stored)
    assert all(_cbv(port, c) == version for c in probed_stored)
