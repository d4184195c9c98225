"""The port's product quantizer (``repro_torch.core.pq``) and Euclidean
k-means against the JAX package.

On one codebook — trained by the JAX package and carried across with
``repro_torch.convert.pq_codebook_from_numpy`` — ``pq_encode``,
``pq_decode``, ``pq_luts``, ``quantization_error``, ``subspace_split`` and
the payload round trip are plain numpy on both sides and must agree bit for
bit.  ``kmeans_euclidean`` makes the same k-means++ draws (compared with no
Lloyd step, bitwise); its torch Lloyd steps match the JAX ones within fp32
rounding on well-separated data (tolerance 1e-5 on centroids of magnitude
~4, assignments exact).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pq as jpq  # noqa: E402
from repro.core.kmeans import kmeans_euclidean as jax_kmeans_l2  # noqa: E402
from repro_torch.convert import pq_codebook_from_numpy  # noqa: E402
from repro_torch.core import pq  # noqa: E402
from repro_torch.core.kmeans import kmeans_euclidean  # noqa: E402

# (n, dim, m): dims divisible and not divisible by m, n below and above the
# 256 centroids of a subspace
GRID = [(30, 15, 4), (200, 33, 8), (300, 16, 8), (500, 24, 24)]


def _emb(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _carried(n, d, m, seed):
    """A JAX-trained codebook and the port's copy of it."""
    jcb = jpq.train_pq(_emb(n, d, seed), m=m, iters=4, seed=seed)
    return jcb, pq_codebook_from_numpy(np.asarray(jcb.codebooks), jcb.dim,
                                       jcb.version)


@pytest.mark.parametrize("n,d,m", GRID)
def test_encode_decode_luts_bitwise_on_a_carried_codebook(n, d, m):
    jcb, cb = _carried(n, d, m, seed=n + d)
    assert (cb.m, cb.dsub, cb.dim, cb.version) == \
        (jcb.m, jcb.dsub, jcb.dim, jcb.version)
    x, q = _emb(n + 17, d, n), _emb(5, d, n + 1)
    codes = pq.pq_encode(cb, x)
    assert codes.dtype == np.uint8
    assert np.array_equal(codes, jpq.pq_encode(jcb, x))
    assert np.array_equal(pq.pq_decode(cb, codes), jpq.pq_decode(jcb, codes))
    luts = pq.pq_luts(cb, q)
    assert luts.dtype == np.float32
    assert np.array_equal(luts, jpq.pq_luts(jcb, q))
    assert np.array_equal(pq.quantization_error(cb, x),
                          jpq.quantization_error(jcb, x))
    assert np.array_equal(pq.subspace_split(x, cb),
                          jpq.subspace_split(x, jcb))


@pytest.mark.parametrize("n,d,m", GRID[:2])
def test_codebook_payload_round_trips_across_packages(n, d, m):
    jcb, cb = _carried(n, d, m, seed=3)
    payload = pq.codebook_to_payload(cb)
    jpayload = jpq.codebook_to_payload(jcb)
    assert payload.keys() == jpayload.keys()
    for name in payload:
        assert payload[name].dtype == jpayload[name].dtype
        assert np.array_equal(payload[name], jpayload[name])
    back = jpq.codebook_from_payload(payload)
    assert np.array_equal(back.codebooks, jcb.codebooks)
    assert (back.dim, back.version) == (jcb.dim, jcb.version)
    again = pq.codebook_from_payload(jpayload)
    assert np.array_equal(again.codebooks, cb.codebooks)


def test_codebook_from_numpy_rejects_a_bad_shape():
    with pytest.raises(ValueError):
        pq_codebook_from_numpy(np.zeros((4, 128, 2), np.float32), 8, 0)


@pytest.mark.parametrize("k,seed", [(5, 0), (40, 1), (256, 2)])
def test_kmeans_euclidean_seeding_draws_equal(k, seed):
    """With no Lloyd step the centroids ARE the k-means++ seeds."""
    x = _emb(300, 12, seed)
    c, a = kmeans_euclidean(x, k, iters=0, seed=seed, device="cpu")
    jc, ja = jax_kmeans_l2(x, k, iters=0, seed=seed)
    assert np.array_equal(c, np.asarray(jc))


def test_kmeans_euclidean_matches_jax_on_separated_data():
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((8, 6)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 8, 400)]
         + 0.1 * rng.standard_normal((400, 6))).astype(np.float32)
    c, a = kmeans_euclidean(x, 8, iters=10, seed=5, device="cpu")
    jc, ja = jax_kmeans_l2(x, 8, iters=10, seed=5)
    assert np.array_equal(a, np.asarray(ja))
    np.testing.assert_allclose(c, np.asarray(jc), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,d,m", GRID)
def test_port_train_pq_error_bound(n, d, m):
    """The reference's reconstruction contract on the port's own training:
    exact when every row can own a centroid, never worse than one centroid
    per subspace otherwise."""
    x = _emb(n, d, n + m)
    cb = pq.train_pq(x, m=m, iters=4, seed=1, device="cpu")
    err = pq.quantization_error(cb, x)
    assert np.all(np.isfinite(err)) and np.all(err >= 0)
    if n <= 256:
        assert float(err.max()) <= 1e-6
    else:
        sub = pq.subspace_split(x, cb)
        k1 = float(np.sum((sub - sub.mean(0, keepdims=True)) ** 2)) / n
        assert float(err.mean()) <= k1 + 1e-6


def test_port_train_pq_matches_jax_at_the_codec_phase_width():
    """The codec phase's PQ configuration (D = 768, m = 8, the storage's 12
    Lloyd steps) on fiqa-like embeddings: both packages train the same
    codebook, so a recall figure at that configuration speaks for the
    configuration, not for the port's training.  Tolerances: codebooks
    within 1e-5 (fp32 rounding of the Lloyd means, centroids of magnitude
    <= 1), mean quantization error within 1e-5 relative, codes equal on at
    least 99.9% of (row, subspace) pairs (argmin near-ties may swap)."""
    from repro_torch.data.synthetic import scaled_beir
    x = scaled_beir("fiqa", n_records=3000, dim=768, n_queries=1,
                    seed=0).embeddings
    jcb = jpq.train_pq(x, m=8, iters=12, seed=0)
    cb = pq.train_pq(x, m=8, iters=12, seed=0, device="cpu")
    np.testing.assert_allclose(cb.codebooks, np.asarray(jcb.codebooks),
                               rtol=0, atol=1e-5)
    err, jerr = (float(pq.quantization_error(cb, x).mean()),
                 float(jpq.quantization_error(jcb, x).mean()))
    assert abs(err - jerr) <= 1e-5 * jerr
    assert np.mean(pq.pq_encode(cb, x) == jpq.pq_encode(jcb, x)) >= 0.999


def test_train_pq_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pq.train_pq(_emb(20, 8, 0), m=2, iters=1)
