"""Embedding models behind one protocol: ``embed(texts) -> (n, dim) f32``
(unit-normalized), plus ``dim``.  A numpy copy of the JAX package's
embedders; the model-backed ``ModelEmbedder`` comes with a later slice.

* :class:`HashingEmbedder` — deterministic char-3-gram random projection.
  Fast and similarity-preserving enough for index unit tests.  Trigram
  hashing runs as a vectorized numpy bulk path (FNV-1a over byte windows),
  so one call over many texts is one feature matmul, not a Python loop per
  character.
* :class:`TableEmbedder` — oracle for synthetic corpora: chunk texts carry a
  ``doc-<id>`` prefix that resolves to a precomputed vector, so regeneration
  at retrieval time reproduces indexing-time embeddings exactly (the paper's
  determinism assumption for online generation).  Non-oracle rows fall back
  to one batched :class:`HashingEmbedder` call.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.data.tokenizer import _fnv1a

_FNV_BASIS = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


class HashingEmbedder:
    def __init__(self, dim: int = 768, seed: int = 0, n_features: int = 4096):
        self.dim = dim
        rng = np.random.default_rng(seed)
        self._proj = rng.standard_normal((n_features, dim)).astype(np.float32)
        self._proj /= np.sqrt(n_features)
        self.n_features = n_features
        self.calls = 0
        self.chars_embedded = 0

    def _trigram_hashes(self, text: str) -> np.ndarray:
        """FNV-1a hash of every char trigram, vectorized over byte windows.

        Equivalent to hashing ``text[i:i+3]`` per position when the text is
        pure ASCII (one byte per char); multibyte texts take the exact
        per-character path.
        """
        t = text.lower()
        data = t.encode("utf-8")
        if len(data) != len(t):          # non-ASCII: exact per-char fallback
            return np.asarray(
                [_fnv1a(t[i:i + 3]) for i in range(len(t) - 2)], np.uint64)
        arr = np.frombuffer(data, np.uint8).astype(np.uint64)
        n = len(arr) - 2
        if n <= 0:
            return np.zeros(0, np.uint64)
        with np.errstate(over="ignore"):
            h = np.full(n, _FNV_BASIS, np.uint64)
            for j in range(3):
                h ^= arr[j:j + n]
                h *= _FNV_PRIME          # wraps mod 2^64 like _fnv1a
        return h

    def _features(self, text: str) -> np.ndarray:
        h = self._trigram_hashes(text)
        if len(h) == 0:
            return np.zeros(self.n_features, np.float32)
        return np.bincount(
            (h % np.uint64(self.n_features)).astype(np.int64),
            minlength=self.n_features).astype(np.float32)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        self.calls += 1
        self.chars_embedded += sum(len(t) for t in texts)
        feats = np.stack([self._features(t) for t in texts])
        out = feats @ self._proj
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.clip(norms, 1e-9, None)

    __call__ = embed


class TableEmbedder:
    """Oracle lookup for synthetic corpora (texts carry 'doc-<id> ...')."""

    def __init__(self, table: Dict[int, np.ndarray], dim: int):
        self.table = table
        self.dim = dim
        self.calls = 0
        self.chars_embedded = 0
        self._fallback = HashingEmbedder(dim=dim, seed=1)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        self.calls += 1
        self.chars_embedded += sum(len(t) for t in texts)
        out = np.empty((len(texts), self.dim), np.float32)
        misses: List[int] = []
        for i, t in enumerate(texts):
            if t.startswith("doc-"):
                did = int(t[4:t.index(" ")] if " " in t else t[4:])
                out[i] = self.table[did]
            else:
                misses.append(i)
        if misses:                       # one batched fallback call
            out[misses] = self._fallback.embed([texts[i] for i in misses])
        return out

    __call__ = embed
