"""The whole slice against the JAX package: ``RAGEngine.answer_batch`` with
the port's index (carried-over centroids) and generator (carried-over
params, ``.reduced(num_layers=2, d_model=128)``) returns the same
``chunk_ids`` and ``output_tokens`` as the JAX engine, and the same modeled
retrieval charges, over consecutive batches that exercise storage, cache
and regeneration: decoding through the per-request generator, and through
each package's ``ContinuousBatcher`` (``batcher=``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import EdgeCostModel as JaxCost  # noqa: E402
from repro.core import EdgeRAGIndex as JaxIndex  # noqa: E402
from repro.data import generate_dataset as jax_dataset  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from repro.serving.engine import GeneratorModel as JaxGenerator  # noqa: E402
from repro.serving.engine import RAGEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (index_state_from_numpy,  # noqa: E402
                                 params_from_jax)
from repro_torch.core import EdgeCostModel, EdgeRAGIndex  # noqa: E402
from repro_torch.data import generate_dataset  # noqa: E402
from repro_torch.serving import (ContinuousBatcher,  # noqa: E402
                                 GeneratorModel, RAGEngine)


def _engines():
    """(JAX engine, port engine, the JAX dataset, the port's), the port's
    index holding the JAX index's clustering and the port's generator the
    JAX generator's params."""
    kw = dict(n_records=600, dim=32, n_topics=24, n_queries=24, seed=2)
    jds, ds = jax_dataset(**kw), generate_dataset(**kw)
    ref_ix = JaxIndex(32, jds.embedder, jds.get_chunks, JaxCost(), slo_s=0.12,
                      cache_bytes=1 << 20)
    assign = ref_ix.build(jds.chunk_ids, jds.texts, nlist=24,
                          embeddings=jds.embeddings)
    port_ix = EdgeRAGIndex(32, ds.embedder, ds.get_chunks, EdgeCostModel(),
                           slo_s=0.12, cache_bytes=1 << 20, device="cpu")
    index_state_from_numpy(port_ix, ref_ix.centroids, assign, ds.chunk_ids,
                           ds.texts, ds.embeddings)
    jcfg = jax_get_config("sheared-llama-2.7b").reduced(num_layers=2,
                                                         d_model=128)
    cfg = get_config("sheared-llama-2.7b").reduced(num_layers=2, d_model=128)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    ref = JaxEngine(ref_ix, JaxGenerator(jcfg, params, max_prompt=48), k=5,
                    nprobe=4, max_new_tokens=6)
    port = RAGEngine(
        port_ix, GeneratorModel(cfg, params_from_jax(
            jax.tree.map(np.asarray, params), cfg, device="cpu"),
            max_prompt=48, device="cpu"),
        k=5, nprobe=4, max_new_tokens=6)
    return ref, port, jds, ds


def _three_batches(ref, port, jds, ds, ref_kw=None, port_kw=None):
    """Three batches of 4 through both engines: the same ids, tokens (6
    each), retrieval charges and TTFT; every tier ran."""
    tiers = np.zeros(3, int)
    for start in (0, 4, 8):
        queries = [f"query {qi}" for qi in range(start, start + 4)]
        embs = ds.query_embs[start:start + 4]
        r = ref.answer_batch(queries, embs, jds.get_chunks, **(ref_kw or {}))
        p = port.answer_batch(queries, embs, ds.get_chunks,
                              **(port_kw or {}))
        for a, b in zip(p, r):
            assert a.chunk_ids == b.chunk_ids
            assert a.output_tokens == b.output_tokens
            assert len(a.output_tokens) == 6
            la, lb = dataclasses.asdict(a.retrieval), dataclasses.asdict(
                b.retrieval)
            la.pop("wall_s"), lb.pop("wall_s")
            assert la == lb
            assert a.ttft_edge_s == b.ttft_edge_s
            assert a.decode_edge_s == b.decode_edge_s
            tiers += [a.retrieval.n_storage_loads, a.retrieval.n_cache_hits,
                      a.retrieval.n_generated]
    assert (tiers > 0).all(), tiers      # stored, cached and regenerated


def test_answer_batch_matches_jax_engine():
    _three_batches(*_engines())


def test_answer_batch_through_the_batcher_matches_jax_engine():
    """``batcher=`` with 2 slots for batches of 4, so admission waits for
    a free slot; prompts go in cut to the batcher's ``max_len``."""
    ref, port, jds, ds = _engines()
    jb = JaxBatcher(ref.generator.cfg, ref.generator.params, num_slots=2,
                    max_len=48)
    pb = ContinuousBatcher(port.generator.cfg, port.generator.params,
                           num_slots=2, max_len=48, device="cpu")
    _three_batches(ref, port, jds, ds, {"batcher": jb}, {"batcher": pb})
    assert all(s.free for s in pb.slots)
    assert sorted(pb.completed) == [0, 1, 2, 3]
