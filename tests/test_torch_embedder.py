"""The port's ``chunk_text`` and ``ModelEmbedder`` against the JAX package.

``chunk_text`` must give the JAX function's chunks on every generated case
and on the edge cases.  ``ModelEmbedder`` (gte-base ``.reduced(num_layers=2,
d_model=256)``, the JAX embedder's parameters carried across with
``params_from_jax``) must give the JAX embedder's rows at batch sizes on
both sides of the port's 256-row micro-batch and of the JAX package's
power-of-two buckets, and the same counters.  Inside the port a row does
not depend on the call it was embedded in, bitwise.  An EdgeRAG index that
regenerates clusters through the model takes the JAX index's tier
decisions and returns its ids.

Tolerance: both sides compute in fp32 on the CPU, but XLA and ATen block
their matmuls and evaluate exp / rsqrt differently, a few ulps per op.
Through two blocks and the pooling, rows of unit norm differ by under
1e-7 (9e-8 at 300 rows); 1e-5 leaves two orders of magnitude.
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import EdgeCostModel as JaxCost  # noqa: E402
from repro.core import EdgeRAGIndex as JaxIndex  # noqa: E402
from repro.data import ModelEmbedder as JaxEmbedder  # noqa: E402
from repro.data.chunking import chunk_text as jax_chunk_text  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import index_state_from_numpy  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import EdgeCostModel, EdgeRAGIndex  # noqa: E402
from repro_torch.data import ModelEmbedder, chunk_text  # noqa: E402
from repro_torch.data import generate_dataset  # noqa: E402
from repro_torch.data.embedder import MICRO_BATCH  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

TOL = 1e-5
# a batch's scores from the two packages: the rows above differ by up to
# TOL, and fp32 dot products over D = 256 by 2 * 256 * 2**-24 * |q| |e|
SCORE_TOL = 2e-5
K, NPROBE = 10, 4


# ---------------------------------------------------------------------------
# chunk_text
# ---------------------------------------------------------------------------
@settings(max_examples=300, deadline=None, database=None)
@given(text=st.text(alphabet="ab c\n", max_size=1500),
       chunk_chars=st.integers(2, 400), data=st.data())
def test_chunk_text_matches_jax(text, chunk_chars, data):
    """Overlaps under half the chunk: the reference loop always advances
    there (a snapped chunk is longer than half of one)."""
    overlap = data.draw(st.integers(0, chunk_chars // 2 - 1))
    assert chunk_text(text, chunk_chars, overlap) == \
        jax_chunk_text(text, chunk_chars, overlap)


@pytest.mark.parametrize("text,chunk_chars,overlap", [
    ("", 300, 50),                          # empty
    ("a short text", 300, 50),              # shorter than a chunk
    ("x" * 300, 300, 50),                   # exactly one chunk
    ("x" * 500, 40, 39),                    # no spaces
    ("x" * 500, 10, 9),
    ("word " * 200, 40, 20),                # overlap >= half the chunk
    ("word " * 200, 40, 30),
])
def test_chunk_text_edge_cases_match_jax(text, chunk_chars, overlap):
    assert chunk_text(text, chunk_chars, overlap) == \
        jax_chunk_text(text, chunk_chars, overlap)


# ---------------------------------------------------------------------------
# ModelEmbedder
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ds():
    return generate_dataset(n_records=400, dim=256, n_topics=20,
                            n_queries=48, seed=3)


@pytest.fixture(scope="module")
def embedders():
    """(JAX embedder, port embedder with the same weights)."""
    jax_emb = JaxEmbedder(seed=1)
    cfg = get_config("gte-base-en-v1.5").reduced(num_layers=2, d_model=256)
    params = params_from_jax(jax.tree.map(np.asarray, jax_emb.params), cfg,
                             device="cpu")
    port = ModelEmbedder(cfg, params, device="cpu")
    return jax_emb, port


def _texts(ds, n):
    """Corpus texts, one of them past ``max_len`` tokens (truncated)."""
    texts = [ds.texts[i % ds.n] for i in range(n)]
    texts[n // 2] = texts[n // 2] + " alpha" * 200
    return texts


def test_reduced_config_and_tokenizer_match_jax(embedders):
    jax_emb, port = embedders
    assert port.cfg == ModelEmbedder(device="cpu").cfg
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(jax_emb.cfg)
    assert (port.dim, port.max_len) == (jax_emb.dim, jax_emb.max_len) == \
        (256, 128)
    assert port.tokenizer.vocab_size == jax_emb.tokenizer.vocab_size


@pytest.mark.parametrize("n", [1, 3, 5, 17, 300])
def test_embed_matches_jax(ds, embedders, n):
    jax_emb, port = embedders
    texts = _texts(ds, n)
    before = (port.calls, port.chars_embedded, jax_emb.calls,
              jax_emb.chars_embedded)
    got, ref = port.embed(texts), np.asarray(jax_emb.embed(texts))
    assert got.shape == ref.shape == (n, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    assert (port.calls - before[0], port.chars_embedded - before[1]) == \
        (jax_emb.calls - before[2], jax_emb.chars_embedded - before[3]) == \
        (1, sum(map(len, texts)))


@pytest.fixture(scope="module")
def call_of_300(ds, embedders):
    texts = _texts(ds, 300)
    return texts, embedders[1].embed(texts)


@pytest.mark.parametrize("at", [0, 7, MICRO_BATCH - 1, MICRO_BATCH, 299])
def test_row_is_bitwise_the_same_alone_and_in_a_call(embedders, call_of_300,
                                                     at):
    """A text alone (one micro-batch of 1 + 255 padded rows) and the same
    text inside a call of 300 (two micro-batches, the second padded) give
    the same bits."""
    texts, rows = call_of_300
    port = embedders[1]
    micro = port.micro_batches
    alone = port.embed([texts[at]])
    assert port.micro_batches == micro + 1
    assert np.array_equal(alone[0], rows[at])


def test_micro_batches_count_encoder_calls(embedders):
    port = embedders[1]
    for n, want in ((0, 0), (1, 1), (MICRO_BATCH, 1), (MICRO_BATCH + 1, 2)):
        before = port.micro_batches
        out = port.embed(["doc-0 x"] * n)
        assert out.shape == (n, 256)
        assert port.micro_batches - before == want


def test_model_embedder_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelEmbedder()
    assert ModelEmbedder(device="cpu").params.device.type == "cpu"


@pytest.mark.parametrize("params_on,device,takes", [
    ("cuda:0", None, True),         # what init_params / params_from_jax give
    ("cuda:0", "cuda", True),
    ("cuda", "cuda:0", True),
    ("cuda:0", "cuda:1", False),
    ("cpu", None, False),
    ("cuda:0", "cpu", False),
])
def test_params_device_against_the_embedders(monkeypatch, params_on, device,
                                             takes):
    """``cuda`` is ``cuda:<current device>``: params that ``Model`` put on
    the card are taken by an embedder that runs on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cfg = get_config("gte-base-en-v1.5").reduced(num_layers=2, d_model=256)
    params = types.SimpleNamespace(device=torch.device(params_on))
    if takes:
        assert ModelEmbedder(cfg, params, device=device).params is params
    else:
        with pytest.raises(ValueError, match="params are on"):
            ModelEmbedder(cfg, params, device=device)


def test_importing_the_data_package_loads_no_model():
    """The model stack loads when a ModelEmbedder is made, not before."""
    code = ("import sys, repro_torch.data\n"
            "print(sorted(m for m in ('torch', 'repro_torch.models')"
            " if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


def test_tokenize_seconds_are_counted(embedders):
    port = embedders[1]
    before = port.tokenize_s
    port.embed(["doc-0 x"] * 5)
    assert port.tokenize_s > before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_params_given_on_the_card(cuda, ds, embedders):
    """Params carried across with ``params_from_jax`` onto the card give
    the CPU embedder's rows; params from ``init_params`` on the card give
    the same bits as the embedder's own draw from the same seed."""
    jax_emb, port_cpu = embedders
    cfg, texts = port_cpu.cfg, _texts(ds, 17)
    carried = ModelEmbedder(cfg, params_from_jax(
        jax.tree.map(np.asarray, jax_emb.params), cfg))
    assert carried.params.device.type == "cuda"
    np.testing.assert_allclose(carried.embed(texts), port_cpu.embed(texts),
                               rtol=0, atol=TOL)
    drawn = ModelEmbedder(cfg, seed=5).embed(texts)
    given = ModelEmbedder(cfg, init_params(cfg, seed=5, device=cuda),
                          device="cuda:0").embed(texts)
    assert np.array_equal(drawn, given)


# ---------------------------------------------------------------------------
# EdgeRAG regenerating through the model
# ---------------------------------------------------------------------------
def test_edgerag_regenerating_through_the_model_matches_jax(ds, embedders):
    """Both indexes embed with the same weights; the port gets the JAX
    index's clustering and build rows.  Under a small cache, clusters are
    regenerated through each package's model in every batch."""
    jax_emb, port_emb = embedders
    cfg = dict(slo_s=0.12, store_heavy=True, cache_bytes=96 << 10)
    built = []

    def jax_embed_fn(texts):
        out = np.asarray(jax_emb.embed(texts))
        built.append(out)
        return out

    ref = JaxIndex(256, jax_embed_fn, ds.get_chunks, JaxCost(), **cfg)
    assign = ref.build(ds.chunk_ids, ds.texts, nlist=20, seed=1)
    port = EdgeRAGIndex(256, port_emb, ds.get_chunks, EdgeCostModel(),
                        device="cpu", **cfg)
    index_state_from_numpy(port, ref.centroids, assign, ds.chunk_ids,
                           ds.texts, built[0])
    assert [c.stored for c in port.clusters] == \
        [c.stored for c in ref.clusters]
    rng = np.random.default_rng(4)
    queries = [ds.texts[i] for i in rng.choice(ds.n, 48, replace=False)]
    query_embs = np.asarray(jax_emb.embed(queries))
    for emb in (jax_emb, port_emb):
        emb.calls = emb.chars_embedded = 0
    tiers = np.zeros(3, int)
    swaps = 0
    for start in range(0, 48, 16):
        q = query_embs[start:start + 16]
        r_ids, r_vals, r_lats = ref.search_batch(q, K, NPROBE)
        p_ids, p_vals, p_lats = port.search_batch(q, K, NPROBE)
        np.testing.assert_allclose(p_vals, np.asarray(r_vals), rtol=0,
                                   atol=SCORE_TOL)
        for qi, lane in zip(*np.nonzero(p_ids != np.asarray(r_ids))):
            v = np.asarray(r_vals)[qi]
            assert any(abs(v[lane] - v[j]) <= 2 * SCORE_TOL
                       for j in (lane - 1, lane + 1) if 0 <= j < K), \
                (start + qi, lane)
            swaps += 1
        dec = [[(x.n_storage_loads, x.n_cache_hits, x.n_generated)
                for x in lats] for lats in (p_lats, r_lats)]
        assert dec[0] == dec[1]
        tiers += np.sum(dec[0], axis=0)
    assert (tiers > 0).all(), tiers           # stored, cached, regenerated
    assert swaps <= 4
    assert (port_emb.calls, port_emb.chars_embedded) == \
        (jax_emb.calls, jax_emb.chars_embedded)
    assert port_emb.chars_embedded > 0
