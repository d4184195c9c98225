"""Embedding models behind one protocol: ``embed(texts) -> (n, dim) f32``
(unit-normalized), plus ``dim``.  The port's copy of the JAX package's
embedders.

* :class:`HashingEmbedder` — deterministic char-3-gram random projection.
  Fast and similarity-preserving enough for index unit tests.  Trigram
  hashing runs as a vectorized numpy bulk path (FNV-1a over byte windows),
  so one call over many texts is one feature matmul, not a Python loop per
  character.
* :class:`ModelEmbedder` — the real thing: the gte-base model
  (``repro_torch.models.encode``) behind the tokenizer, on the card unless
  asked for the CPU.  Rows go through the encoder in micro-batches of one
  pinned size, :data:`MICRO_BATCH`, so a text's embedding is the same bits
  whether it is embedded alone, in one cluster's regeneration or in the
  corpus build.
* :class:`TableEmbedder` — oracle for synthetic corpora: chunk texts carry a
  ``doc-<id>`` prefix that resolves to a precomputed vector, so regeneration
  at retrieval time reproduces indexing-time embeddings exactly (the paper's
  determinism assumption for online generation).  Non-oracle rows fall back
  to one batched :class:`HashingEmbedder` call.
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data.tokenizer import _fnv1a

if TYPE_CHECKING:                        # the model stack loads on first use
    import torch

    from repro_torch.device import DeviceLike
    from repro_torch.models import Model

_FNV_BASIS = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)

# texts per encoder call of ModelEmbedder.  The JAX package pads a whole
# call to the next power of two in one program; a corpus build of 25,000
# texts would then be one (32768, 128)-token batch whose MLP activations
# alone outgrow the card.  One pinned size also gives every GEMM and every
# attention launch the same shapes whatever the call.
MICRO_BATCH = 256


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


class ModelEmbedder:
    """gte-base-en-v1.5 (paper Table 3) on the port's model: every layer's
    attention is the non-causal ``flash_attention`` kernel on the card, the
    plain function on the CPU.  ``params`` is a port :class:`Model` (from
    ``convert.params_from_jax`` or ``init_params``) on ``device``; None
    draws one from ``seed``."""

    def __init__(self, cfg=None, params: Optional[Model] = None, *,
                 max_len: int = 128, seed: int = 0, reduced: bool = True,
                 device: DeviceLike = None):
        from repro_torch.configs import get_config
        from repro_torch.data.tokenizer import HashingTokenizer
        from repro_torch.device import resolve_device, same_device
        from repro_torch.models import encode, init_params
        self._encode = encode
        dev = resolve_device(device)
        if cfg is None:
            cfg = get_config("gte-base-en-v1.5")
            if reduced:
                cfg = cfg.reduced(num_layers=2, d_model=256)
        self.cfg = cfg
        self.dim = cfg.d_model
        if params is None:
            params = init_params(cfg, seed=seed, device=dev)
        elif not same_device(params.device, dev):
            raise ValueError(f"params are on {params.device}, the embedder "
                             f"runs on {dev}")
        self.params = params
        self.tokenizer = HashingTokenizer(vocab_size=cfg.vocab_size)
        self.max_len = max_len
        self.calls = 0
        self.chars_embedded = 0
        self.micro_batches = 0          # encoder calls of MICRO_BATCH rows
        self.tokenize_s = 0.0           # host seconds in the tokenizer

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Tokenize, then encode :data:`MICRO_BATCH` rows at a time; the
        last micro-batch is padded with rows kept mask-valid, and the
        padded rows are sliced off.  A row depends only on its own tokens
        (``encode`` attends within a sequence), so this is the function
        the JAX package computes."""
        import torch
        self.calls += 1
        self.chars_embedded += sum(len(t) for t in texts)
        t0 = time.perf_counter()
        toks, mask = self.tokenizer.encode_batch(list(texts), self.max_len)
        self.tokenize_s += time.perf_counter() - t0
        n, dev = toks.shape[0], self.params.device
        parts = []
        for start in range(0, n, MICRO_BATCH):
            t = toks[start:start + MICRO_BATCH]
            m = mask[start:start + MICRO_BATCH]
            b = t.shape[0]
            if b < MICRO_BATCH:
                pad = ((0, MICRO_BATCH - b), (0, 0))
                t, m = np.pad(t, pad), np.pad(m, pad)
                m[b:, 0] = 1             # keep padded rows mask-valid
            batch = {"tokens": torch.from_numpy(t).long().to(dev),
                     "attn_mask": torch.from_numpy(m).to(dev)}
            parts.append(self._encode(self.params, batch)[:b])
            self.micro_batches += 1
        if not parts:
            return np.zeros((0, self.dim), np.float32)
        # one copy back to the host: the index protocol takes numpy
        return torch.cat(parts).cpu().numpy()

    __call__ = embed
