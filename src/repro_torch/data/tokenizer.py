"""Hashing word tokenizer — deterministic, vocabulary-free.

The paper's stack uses a trained sentencepiece; offline we hash whitespace
words into a fixed id space.  Deterministic across processes (no PYTHONHASHSEED
dependence: FNV-1a).
"""
from __future__ import annotations

from typing import List

import numpy as np


def _fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s.encode("utf-8"):
        h ^= ch
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class HashingTokenizer:
    def __init__(self, vocab_size: int = 30528, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self.pad_id = 0
        self.bos_id = 1

    def encode(self, text: str, max_len: int = 0) -> List[int]:
        if self.lowercase:
            text = text.lower()
        ids = [self.bos_id] + [
            2 + _fnv1a(w) % (self.vocab_size - 2) for w in text.split()]
        if max_len:
            ids = ids[:max_len]
        return ids

    def encode_batch(self, texts: List[str], max_len: int) -> np.ndarray:
        """Padded (B, max_len) int32 + attention mask."""
        out = np.zeros((len(texts), max_len), np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, max_len)
            out[i, :len(ids)] = ids
            mask[i, :len(ids)] = 1
        return out, mask
