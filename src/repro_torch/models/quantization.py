"""Per-row int8 quantization of embedding matrices (the int8 storage codec).

Port of the storage half of ``repro.models.quantization`` (``quantize_rows``
/ ``dequantize_rows``) as plain numpy, so the port writes the same bytes as
the JAX package.  Symmetric per-row scheme: one scale per embedding row,
narrowed to fp16 on the storage side (2 B per row against 4·d B of fp32
embeddings).  The int8 KV-cache half comes with the decode-attention kernel
over an int8 cache.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def quantize_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, d) f32 -> (int8 (n, d), fp16 scales (n, 1)).

    The scale is snapped to its STORED fp16 value — clamped to the fp16
    minimum normal so tiny-magnitude rows quantize with bounded error
    instead of decoding to zeros off an underflowed scale — and the int8
    values are computed against that snapped scale.
    """
    x = np.ascontiguousarray(x, np.float32)
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    f16 = np.finfo(np.float16)
    # clamp both ways: an underflowed scale decodes rows to zero, an
    # overflowed one (inf) decodes them to NaN
    scale = np.clip(amax / 127.0, f16.tiny, f16.max).astype(np.float16)
    q = np.clip(np.round(x / scale.astype(np.float32)), -127, 127)
    return q.astype(np.int8), scale


def dequantize_rows(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_rows`; returns contiguous f32 (n, d)."""
    return np.ascontiguousarray(
        q.astype(np.float32) * scale.astype(np.float32))
