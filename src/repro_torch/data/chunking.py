"""Corpus pre-processing: split documents into overlapping chunks
(RAG indexing step ①, Fig. 1a).  A copy of the JAX package's
``repro.data.chunking``, with the same outputs."""
from __future__ import annotations

from typing import List


def chunk_text(text: str, chunk_chars: int = 300,
               overlap_chars: int = 50) -> List[str]:
    """Overlapping character-window chunking, snapped to word boundaries."""
    if len(text) <= chunk_chars:
        return [text] if text else []
    chunks = []
    stride = chunk_chars - overlap_chars
    start = 0
    while start < len(text):
        end = min(start + chunk_chars, len(text))
        if end < len(text):
            # snap end to the previous word boundary
            sp = text.rfind(" ", start, end)
            if sp > start + chunk_chars // 2:
                end = sp
        chunks.append(text[start:end])
        if end == len(text):
            break
        start = end - overlap_chars
        if start <= 0:
            start = end
    return chunks
