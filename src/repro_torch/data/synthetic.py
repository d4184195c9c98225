"""Synthetic BEIR-like corpora matched to the paper's workload structure.

Real BEIR isn't downloadable offline, so we generate corpora that preserve
the three properties EdgeRAG exploits (Table 2, Fig. 4, Fig. 5):

  1. topical cluster structure with a LOG-NORMAL size tail — a few clusters
     are far larger than the median (Fig. 5's tail-heavy generation cost);
  2. skewed query access with the paper's chunk REUSE RATIOS — queries
     revisit clusters Zipf-style (Table 2 'Reuse Ratio' column);
  3. per-chunk text whose char count drives the embedding cost model.

Each dataset entry carries the paper's Table 2 identity (records, embedding
bytes, fits-in-memory flag) so benchmarks can scale the cost model's device
memory to reproduce the in/out-of-memory regimes at laptop record counts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data.embedder import TableEmbedder

_WORDS = ("the quick brown fox jumps over lazy dog alpha beta gamma delta "
          "epsilon zeta eta theta iota kappa lambda sigma tau phi chi psi "
          "omega data vector index query cluster memory cache edge device "
          "retrieval augmented generation model token latency storage").split()


@dataclasses.dataclass
class BeirSpec:
    """Paper Table 2 row."""
    name: str
    corpus_mb: float
    n_records: int
    emb_bytes: int
    unique_access: int
    total_access: int
    reuse_ratio: float
    fits_in_memory: bool
    slo_s: float


BEIR_SPECS: Dict[str, BeirSpec] = {
    "scidocs": BeirSpec("scidocs", 86, 3_600, 113 << 20, 1157, 2000, 1.73, True, 1.0),
    "fiqa": BeirSpec("fiqa", 130, 25_000, 217 << 20, 2974, 13286, 4.47, True, 1.0),
    "quora": BeirSpec("quora", 641, 523_000, int(1.5 * 2**30), 15672, 30000, 1.91, True, 1.0),
    "nq": BeirSpec("nq", 4_600, 2_680_000, int(8.3 * 2**30), 8186, 10235, 1.25, False, 1.5),
    "hotpotqa": BeirSpec("hotpotqa", 11_000, 5_420_000, int(15.4 * 2**30), 15519, 22098, 1.42, False, 1.5),
    "fever": BeirSpec("fever", 7_500, 5_230_000, int(18.5 * 2**30), 5783, 13922, 2.41, False, 1.5),
}


@dataclasses.dataclass
class SyntheticDataset:
    name: str
    spec: Optional[BeirSpec]
    chunk_ids: np.ndarray               # (n,)
    texts: List[str]
    embeddings: np.ndarray              # (n, dim) unit-norm (for clustering)
    topic_of_chunk: np.ndarray          # (n,) ground-truth topic
    query_embs: np.ndarray              # (nq, dim)
    query_chars: np.ndarray             # (nq,)
    query_topic: np.ndarray             # (nq,)
    embedder: TableEmbedder
    scale: float = 1.0                  # n_records / spec.n_records

    @property
    def n(self) -> int:
        return len(self.chunk_ids)

    def __post_init__(self):
        self._store: Dict[int, str] = {
            int(i): t for i, t in zip(self.chunk_ids, self.texts)}

    def get_chunks(self, ids: Sequence[int]) -> List[str]:
        return [self._store[int(i)] for i in ids]

    def add_chunk(self, chunk_id: int, text: str,
                  embedding: Optional[np.ndarray] = None):
        """Register a new chunk (online insertion path)."""
        self._store[int(chunk_id)] = text
        if embedding is not None:
            self.embedder.table[int(chunk_id)] = np.asarray(
                embedding, np.float32)

    def relevant(self, qi: int, min_overlap: int = 1) -> set:
        """Ground-truth relevant chunk ids for query qi (same topic)."""
        return set(np.where(self.topic_of_chunk == self.query_topic[qi])[0]
                   .tolist())


def _make_text(did: int, n_chars: int, rng: np.random.Generator) -> str:
    words = [f"doc-{did}"]
    ln = len(words[0])
    while ln < n_chars:
        w = _WORDS[int(rng.integers(len(_WORDS)))]
        words.append(w)
        ln += len(w) + 1
    return " ".join(words)[:max(n_chars, len(words[0]))]


def generate_dataset(name: str = "synthetic", n_records: int = 2000,
                     dim: int = 64, n_topics: int = 64,
                     n_queries: int = 200, seed: int = 0,
                     tail_sigma: float = 1.0, zipf_a: float = 1.3,
                     mean_chunk_chars: int = 300,
                     noise: float = 0.35) -> SyntheticDataset:
    """Build a corpus with log-normal topic sizes and Zipf query reuse."""
    rng = np.random.default_rng(seed)
    spec = BEIR_SPECS.get(name)
    # topic sizes: log-normal tail (Fig. 5 shape), normalized to n_records
    raw = rng.lognormal(mean=0.0, sigma=tail_sigma, size=n_topics)
    sizes = np.maximum(1, np.round(raw / raw.sum() * n_records)).astype(int)
    while sizes.sum() > n_records:
        sizes[np.argmax(sizes)] -= 1
    while sizes.sum() < n_records:
        sizes[np.argmin(sizes)] += 1
    topics = rng.standard_normal((n_topics, dim)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)

    embs, topic_of_chunk, texts = [], [], []
    table: Dict[int, np.ndarray] = {}
    did = 0
    for t, sz in enumerate(sizes):
        vecs = topics[t][None] + noise * rng.standard_normal((sz, dim))
        vecs = (vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
                ).astype(np.float32)
        for v in vecs:
            chars = max(40, int(rng.normal(mean_chunk_chars,
                                           mean_chunk_chars * 0.3)))
            texts.append(_make_text(did, chars, rng))
            table[did] = v
            embs.append(v)
            topic_of_chunk.append(t)
            did += 1
    embeddings = np.stack(embs)
    topic_of_chunk = np.asarray(topic_of_chunk)

    # queries: Zipf over topics ranked by size (big clusters get re-hit),
    # reproducing Table 2's reuse skew
    rank = np.argsort(-sizes)
    zipf_draws = rng.zipf(zipf_a, size=n_queries)
    q_topics = rank[np.minimum(zipf_draws - 1, n_topics - 1)]
    q_vecs = (topics[q_topics]
              + noise * rng.standard_normal((n_queries, dim)))
    q_vecs = (q_vecs / np.linalg.norm(q_vecs, axis=1, keepdims=True)
              ).astype(np.float32)
    q_chars = rng.integers(40, 160, size=n_queries)

    ds = SyntheticDataset(
        name=name, spec=spec,
        chunk_ids=np.arange(did, dtype=np.int64),
        texts=texts, embeddings=embeddings,
        topic_of_chunk=topic_of_chunk,
        query_embs=q_vecs, query_chars=q_chars,
        query_topic=np.asarray(q_topics),
        embedder=TableEmbedder(table, dim),
        scale=(n_records / spec.n_records) if spec else 1.0)
    return ds


def scaled_beir(name: str, n_records: int = 3000, dim: int = 64,
                n_queries: int = 200, seed: int = 0) -> SyntheticDataset:
    """Scaled-down analogue of a Table 2 dataset (same skew structure).

    The number of topics scales with sqrt(n) and the Zipf parameter is tuned
    per dataset so the realized reuse ratio approaches Table 2's column.
    """
    spec = BEIR_SPECS[name]
    # higher reuse ratio -> more concentrated queries -> larger zipf a
    zipf_a = {"scidocs": 1.5, "fiqa": 2.2, "quora": 1.6, "nq": 1.25,
              "hotpotqa": 1.35, "fever": 1.8}[name]
    n_topics = max(16, int(np.sqrt(n_records) * 2))
    return generate_dataset(name=name, n_records=n_records, dim=dim,
                            n_topics=n_topics, n_queries=n_queries,
                            seed=seed, zipf_a=zipf_a)
