"""The paper's Table 4 baselines in the port (``FlatIndex``, ``IVFIndex``)
against the JAX package on ``tests/test_core.py``'s corpus.

The port's IVF index is loaded with the JAX index's centroids and
assignment (``repro_torch.convert.ivf_state_from_numpy``): k-means argmin
near-ties make two separately trained indexes a bad comparison.  On the
CPU (``device="cpu"``, the plain version of ``ivf_topk``), scores agree
within the bound of two fp32 summation orders (``_tol``), ids are equal
wherever no other score lies within that bound, and the memory and the
modeled ``LatencyBreakdown`` fields are exactly equal (the same formulas
on the same decisions).  Then the port's own versions of the reference's
baseline tests, the build against the JAX build where k-means has no
near-ties, and, on the card (``gpu``), both baselines against the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EdgeCostModel as JaxCost  # noqa: E402
from repro.core import FlatIndex as JaxFlat  # noqa: E402
from repro.core import IVFIndex as JaxIVF  # noqa: E402
from repro.data import generate_dataset as jax_dataset  # noqa: E402
from repro_torch.convert import (index_state_from_numpy,  # noqa: E402
                                 ivf_state_from_numpy)
from repro_torch.core import (EdgeCostModel, EdgeRAGIndex,  # noqa: E402
                              FlatIndex, IVFIndex)
from repro_torch.data import generate_dataset  # noqa: E402
from repro_torch.kernels.ivf_topk import topk_ip  # noqa: E402

DIM, NLIST, K = 48, 40, 10


def _tol(e: np.ndarray, q: np.ndarray) -> float:
    """Two fp32 sums of the same D products in different orders differ by
    at most 2 * D * 2**-24 * sum|q_i e_i| (``test_torch_kernels._tol``)."""
    d = e.shape[1]
    return float(2 * d * 2.0 ** -24 * (np.abs(q) @ np.abs(e).T).max())


@pytest.fixture(scope="module")
def ds():
    return generate_dataset(n_records=1200, dim=DIM, n_topics=40,
                            n_queries=120, seed=3)


@pytest.fixture(scope="module")
def jds():
    return jax_dataset(n_records=1200, dim=DIM, n_topics=40, n_queries=120,
                       seed=3)


@pytest.fixture(scope="module")
def tol(ds):
    return _tol(ds.embeddings, ds.query_embs)


@pytest.fixture(scope="module")
def flats(ds, jds):
    assert np.array_equal(ds.embeddings, jds.embeddings)
    assert np.array_equal(ds.query_embs, jds.query_embs)
    ref = JaxFlat(DIM, JaxCost())
    ref.add(jds.embeddings, jds.chunk_ids)
    port = FlatIndex(DIM, EdgeCostModel(), device="cpu")
    port.add(ds.embeddings, ds.chunk_ids)
    return ref, port


@pytest.fixture(scope="module")
def ivfs(ds, jds):
    ref = JaxIVF(DIM, JaxCost())
    assign = ref.build(jds.embeddings, jds.chunk_ids, nlist=NLIST, seed=1)
    port = IVFIndex(DIM, EdgeCostModel(), device="cpu")
    ivf_state_from_numpy(port, ref.centroids, assign, ds.chunk_ids,
                         ds.embeddings)
    return ref, port, np.asarray(assign)


def _lat_fields(lat):
    d = dataclasses.asdict(lat)
    d.pop("wall_s")
    return d


def _assert_topk_agrees(p_ids, p_vals, r_ids, r_vals, full, tol):
    """Scores within ``tol``; an id may differ from the reference's only
    where a neighbouring score lies within 2 * ``tol``, and the id sets are
    equal wherever the k-th and (k+1)-th scores of ``full`` (Q, N) differ
    by more than 2 * ``tol``.  Returns the lanes that swapped."""
    p_ids, r_ids = np.asarray(p_ids), np.asarray(r_ids)
    p_vals, r_vals = np.asarray(p_vals), np.asarray(r_vals)
    assert p_ids.shape == r_ids.shape and p_vals.dtype == np.float32
    np.testing.assert_allclose(p_vals, r_vals, rtol=0, atol=tol)
    k = r_ids.shape[1]
    srt = np.sort(full, axis=1)[:, ::-1]
    swaps = 0
    for qi, lane in zip(*np.nonzero(p_ids != r_ids)):
        v = r_vals[qi]
        assert any(abs(v[lane] - v[j]) <= 2 * tol
                   for j in (lane - 1, lane + 1) if 0 <= j < k), (qi, lane)
        swaps += 1
    for qi in range(len(r_ids)):
        if k < srt.shape[1] and srt[qi, k - 1] - srt[qi, k] > 2 * tol:
            assert set(p_ids[qi].tolist()) == set(r_ids[qi].tolist()), qi
    return swaps


# ---------------------------------------------------------------------------
# FlatIndex
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nq", [1, 16, 120])
def test_flat_matches_jax(ds, flats, tol, nq):
    ref, port = flats
    assert port.ntotal == ref.ntotal == 1200
    assert port.memory_bytes() == ref.memory_bytes() == 1200 * DIM * 4
    q = ds.query_embs[:nq]
    full = q.astype(np.float64) @ ds.embeddings.T.astype(np.float64)
    r_ids, r_vals, r_lat = ref.search(q, K)
    p_ids, p_vals, p_lat = port.search(q, K)
    assert p_ids.dtype == np.int64
    assert _assert_topk_agrees(p_ids, p_vals, r_ids, r_vals, full, tol) <= 2
    assert _lat_fields(p_lat) == _lat_fields(r_lat)
    assert p_lat.wall_s > 0


def test_flat_two_adds_equal_one(ds, flats):
    _, one = flats
    two = FlatIndex(DIM, EdgeCostModel(), device="cpu")
    two.add(ds.embeddings[:500], ds.chunk_ids[:500])
    two.add(ds.embeddings[500:], ds.chunk_ids[500:])
    assert two.ntotal == one.ntotal
    assert two.memory_bytes() == one.memory_bytes()
    q = ds.query_embs[:16]
    a, b = two.search(q, K), one.search(q, K)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert _lat_fields(a[2]) == _lat_fields(b[2])
    # the JAX index added in two calls agrees too
    ref = JaxFlat(DIM, JaxCost())
    ref.add(ds.embeddings[:500], ds.chunk_ids[:500])
    ref.add(ds.embeddings[500:], ds.chunk_ids[500:])
    assert np.array_equal(np.asarray(ref.search(q, K)[0]), a[0])


def test_flat_k_over_ntotal_pads(ds):
    port = FlatIndex(DIM, EdgeCostModel(), device="cpu")
    port.add(ds.embeddings[:7], ds.chunk_ids[:7] + 100)
    ref = JaxFlat(DIM, JaxCost())
    ref.add(ds.embeddings[:7], ds.chunk_ids[:7] + 100)
    q = ds.query_embs[:3]
    p_ids, p_vals, p_lat = port.search(q, K)
    r_ids, r_vals, r_lat = ref.search(q, K)
    assert (p_ids[:, 7:] == -1).all() and np.isneginf(p_vals[:, 7:]).all()
    assert set(p_ids[:, :7].ravel().tolist()) == set(range(100, 107))
    assert np.array_equal(p_ids, np.asarray(r_ids))
    np.testing.assert_allclose(p_vals[:, :7], np.asarray(r_vals)[:, :7],
                               rtol=0, atol=_tol(ds.embeddings[:7], q))
    assert _lat_fields(p_lat) == _lat_fields(r_lat)


# ---------------------------------------------------------------------------
# IVFIndex, with the JAX index's clustering
# ---------------------------------------------------------------------------
def test_ivf_state_matches_jax(ivfs):
    ref, port, _ = ivfs
    assert port.nlist == ref.nlist == NLIST
    assert port.ntotal == ref.ntotal == 1200
    assert port.memory_bytes() == ref.memory_bytes()
    assert isinstance(port.centroids, torch.Tensor)
    assert np.array_equal(port.centroids.numpy(), np.asarray(ref.centroids))
    for p, r in zip(port.clusters, ref.clusters):
        assert np.array_equal(p.ids, r.ids) and p.size == r.size
        assert np.array_equal(p.embeddings.numpy(), r.embeddings)


@pytest.mark.parametrize("nprobe", [1, 5, NLIST + 3])
def test_ivf_probe_matches_jax(ds, ivfs, nprobe):
    ref, port, _ = ivfs
    q = ds.query_embs
    p, r = port.probe(q, nprobe), np.asarray(ref.probe(q, nprobe))
    assert p.shape == r.shape == (len(q), min(nprobe, NLIST))
    assert np.array_equal(p, r)


@pytest.mark.parametrize("nprobe", [1, 5, NLIST])
def test_ivf_search_matches_jax(ds, ivfs, tol, nprobe):
    ref, port, _ = ivfs
    swaps = 0
    for qi in range(len(ds.query_embs)):
        q = ds.query_embs[qi]
        r_ids, r_vals, r_lat = ref.search(q, K, nprobe)
        p_ids, p_vals, p_lat = port.search(q, K, nprobe)
        rows = np.concatenate([ref.clusters[int(i)].embeddings
                               for i in np.asarray(ref.probe(q, nprobe))[0]])
        full = q[None].astype(np.float64) @ rows.T.astype(np.float64)
        swaps += _assert_topk_agrees(p_ids, p_vals, r_ids, r_vals, full,
                                     tol)
        assert _lat_fields(p_lat) == _lat_fields(r_lat), qi
    assert swaps <= 2


def test_ivf_all_empty_probe_returns_padding(ds, ivfs):
    """Every probed cluster pruned: the ``(-1, -inf)`` early exit, with
    the probe count set and nothing else charged, as in the reference."""
    ref, port, assign = ivfs
    pruned = IVFIndex(DIM, EdgeCostModel(), device="cpu")
    ivf_state_from_numpy(pruned, ref.centroids, assign, ds.chunk_ids,
                         ds.embeddings)
    jpruned = JaxIVF(DIM, JaxCost())
    jpruned.centroids = ref.centroids
    jpruned.clusters = [dataclasses.replace(c) for c in ref.clusters]
    q = ds.query_embs[0]
    for c in port.probe(q, 3)[0]:
        pruned.clusters[int(c)].embeddings = None
        jpruned.clusters[int(c)].embeddings = None
    p_ids, p_vals, p_lat = pruned.search(q, K, 3)
    r_ids, r_vals, r_lat = jpruned.search(q, K, 3)
    assert p_ids.shape == (1, K) and (p_ids == -1).all()
    assert p_vals.dtype == np.float32 and np.isneginf(p_vals).all()
    assert np.array_equal(p_ids, r_ids) and np.array_equal(p_vals, r_vals)
    assert dataclasses.asdict(p_lat) == dataclasses.asdict(r_lat)
    assert p_lat.n_clusters_probed == 3 and p_lat.wall_s == 0.0
    assert pruned.memory_bytes() < port.memory_bytes()
    # an unpruned cluster in the probe set scans again
    assert (pruned.search(q, K, 4)[0] >= 0).any()


def test_ivf_search_is_per_query(ds, ivfs):
    _, port, _ = ivfs
    with pytest.raises(AssertionError, match="per-query"):
        port.search(ds.query_embs[:2], K, 5)


def test_ivf_build_matches_jax():
    """k-means inside ``build`` on well-separated clusters (no argmin
    near-ties): the port's clustering is the JAX package's."""
    rng = np.random.default_rng(8)
    centers = rng.standard_normal((6, 16))
    x = (centers[rng.integers(0, 6, 400)]
         + 0.1 * rng.standard_normal((400, 16))).astype(np.float32)
    ids = np.arange(400) * 3
    ref = JaxIVF(16, JaxCost())
    r_assign = ref.build(x, ids, nlist=6, seed=2)
    port = IVFIndex(16, EdgeCostModel(), device="cpu")
    p_assign = port.build(x, ids, nlist=6, seed=2)
    assert np.array_equal(p_assign, np.asarray(r_assign))
    np.testing.assert_allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids), rtol=0, atol=1e-5)
    assert [c.ids.tolist() for c in port.clusters] == \
        [c.ids.tolist() for c in ref.clusters]
    assert port.memory_bytes() == ref.memory_bytes()


# ---------------------------------------------------------------------------
# the reference's baseline tests, on the port alone
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stack(ds):
    """Port flat, IVF and EdgeRAG indexes; EdgeRAG holds the IVF index's
    clustering (``tests/test_core.py``'s stack trains both with seed 1)."""
    cost = EdgeCostModel()
    flat = FlatIndex(DIM, cost, device="cpu")
    flat.add(ds.embeddings, ds.chunk_ids)
    ivf = IVFIndex(DIM, cost, device="cpu")
    assign = ivf.build(ds.embeddings, ds.chunk_ids, nlist=NLIST, seed=1)
    er = EdgeRAGIndex(DIM, ds.embedder, ds.get_chunks, cost, slo_s=0.3,
                      cache_bytes=1 << 20, device="cpu")
    index_state_from_numpy(er, ivf.centroids.numpy(), assign, ds.chunk_ids,
                           ds.texts, ds.embeddings)
    return flat, ivf, er


def test_edgerag_results_identical_to_ivf(stack, ds):
    """§6.3.1: EdgeRAG retrieval ≡ two-level IVF retrieval (same clustering)."""
    _, ivf, er = stack
    for qi in range(40):
        i_ids, i_vals, _ = ivf.search(ds.query_embs[qi], 10, 5)
        e_ids, e_vals, _ = er.search(ds.query_embs[qi], 10, 5)
        assert set(i_ids[0].tolist()) == set(e_ids[0].tolist())
        np.testing.assert_allclose(np.sort(i_vals[0]), np.sort(e_vals[0]),
                                   atol=1e-4)


def test_recall_improves_with_nprobe(stack, ds):
    flat, ivf, _ = stack
    recs = []
    for nprobe in (1, 4, 16, 40):
        hits = 0
        for qi in range(40):
            f_ids, _, _ = flat.search(ds.query_embs[qi], 10)
            i_ids, _, _ = ivf.search(ds.query_embs[qi], 10, nprobe)
            hits += len(set(f_ids[0].tolist()) & set(i_ids[0].tolist()))
        recs.append(hits / (40 * 10))
    assert recs[-1] > 0.999       # probing everything == exhaustive
    assert recs == sorted(recs)   # monotone in nprobe


def test_memory_hierarchy_ordering():
    """EdgeRAG resident << IVF resident == Flat resident + centroids."""
    ds = generate_dataset(n_records=800, dim=32, n_topics=24, seed=0)
    cost = EdgeCostModel()
    flat = FlatIndex(32, cost, device="cpu")
    flat.add(ds.embeddings, ds.chunk_ids)
    ivf = IVFIndex(32, cost, device="cpu")
    ivf.build(ds.embeddings, ds.chunk_ids, nlist=24)
    er = EdgeRAGIndex(32, ds.embedder, ds.get_chunks, cost, slo_s=0.2,
                      device="cpu")
    er.build(ds.chunk_ids, ds.texts, nlist=24, embeddings=ds.embeddings)
    assert er.memory_bytes() < 0.1 * ivf.memory_bytes()
    assert abs(ivf.memory_bytes() - flat.memory_bytes()) \
        <= ivf.centroids.nbytes


# ---------------------------------------------------------------------------
# on the card (only there)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 64])
def test_cuda_baselines_match_cpu(cuda, k):
    """Both baselines on the card against the CPU: a flat scan of 25,000 x
    768 (past the 2,048 rows where ``ivf_topk`` takes 64-row tiles) and
    an IVF index on the same clustering, one query at a time."""
    rng = np.random.default_rng(21)
    n, d = 25_000, 768
    e = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((16, d)).astype(np.float32)
    ids = rng.permutation(n).astype(np.int64) + 7
    tol = _tol(e, q)
    full = q.astype(np.float64) @ e.T.astype(np.float64)
    cpu, card = (FlatIndex(d, device=dev) for dev in ("cpu", cuda))
    for ix in (cpu, card):
        ix.add(e[:9_000], ids[:9_000])
        ix.add(e[9_000:], ids[9_000:])
    assert card._embs.device.type == "cuda"
    assert card.memory_bytes() == cpu.memory_bytes() == n * d * 4
    before = topk_ip.launches
    g_ids, g_vals, g_lat = card.search(q, k)
    assert topk_ip.launches == before + 1
    c_ids, c_vals, c_lat = cpu.search(q, k)
    _assert_topk_agrees(g_ids, g_vals, c_ids, c_vals, full, tol)
    assert _lat_fields(g_lat) == _lat_fields(c_lat)
    for i in range(len(q)):                 # a batch is its queries alone
        one = card.search(q[i], k)
        assert np.array_equal(one[0][0], g_ids[i])
        assert np.array_equal(one[1][0], g_vals[i])

    cpu_ivf = IVFIndex(d, device="cpu")
    assign = cpu_ivf.build(e[:4_000], ids[:4_000], nlist=20, seed=1)
    card_ivf = IVFIndex(d, device=cuda)
    ivf_state_from_numpy(card_ivf, cpu_ivf.centroids.numpy(), assign,
                         ids[:4_000], e[:4_000])
    assert card_ivf.centroids.device.type == "cuda"
    assert card_ivf.memory_bytes() == cpu_ivf.memory_bytes()
    for i in range(len(q)):
        before = topk_ip.launches
        g = card_ivf.search(q[i], k, 4)
        assert topk_ip.launches == before + 2        # probe + scan
        c = cpu_ivf.search(q[i], k, 4)
        rows = np.concatenate([cpu_ivf.clusters[int(j)].embeddings.numpy()
                               for j in cpu_ivf.probe(q[i], 4)[0]])
        assert np.array_equal(card_ivf.probe(q[i], 4), cpu_ivf.probe(q[i], 4))
        _assert_topk_agrees(g[0], g[1], c[0], c[1],
                            q[i:i + 1].astype(np.float64) @ rows.T, tol)
        assert _lat_fields(g[2]) == _lat_fields(c[2])
