"""Int8 quantization: the KV cache (per-token-per-head scales) and the
embedding matrices of the int8 storage codec (per-row scales).

Port of ``repro.models.quantization``.  Both halves are one symmetric
scheme: int8 values and one scale per row of the last dim.

* KV cache (:class:`QuantKV`, :func:`quantize_kv`, :func:`quant_insert`,
  :func:`init_quant_cache`): one f32 scale per (token, kv head), in plain
  torch on either device.  The decode-attention kernel over such a cache
  (``kernels.decode_attention.decode_attention_q8``) dequantizes each
  element right after its load.  Unlike the JAX package's functional
  version, :func:`quant_insert` writes the cache IN PLACE, as
  ``KVCache.insert`` does.
* Storage (:func:`quantize_rows` / :func:`dequantize_rows`): plain numpy,
  so the port writes the same bytes as the JAX package.  One scale per
  embedding row, narrowed to fp16 on the storage side (2 B per row against
  4·d B of fp32 embeddings).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch


class QuantKV(NamedTuple):
    q: torch.Tensor          # int8 (B, S, KH, D)
    scale: torch.Tensor      # f32  (B, S, KH, 1)


def quantize_kv(x: torch.Tensor) -> QuantKV:
    """x (..., D) -> int8 values + a per-(...,) f32 scale over the last dim:
    scale = max(amax, 1e-8) / 127, values round(x / scale) (half to even)
    clipped to +-127, in f32 and in the JAX package's order."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor where x lies: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, an ulp off the true quotient
    scale = torch.clamp_min(amax, 1e-8) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return QuantKV(q.to(torch.int8), scale)


def dequantize_kv(qkv: QuantKV, dtype=torch.float32) -> torch.Tensor:
    return (qkv.q.to(torch.float32) * qkv.scale).to(dtype)


def quant_insert(cache: QuantKV, new: torch.Tensor,
                 pos: Union[int, torch.Tensor]) -> QuantKV:
    """Quantize ``new`` (B, S_new, KH, D) and write it IN PLACE (the JAX
    version returns a new cache): at position ``pos`` in every slot, or,
    for a (B,) tensor ``pos`` (S_new == 1), slot b's row at ``pos[b]``.
    Returns ``cache``.  Positions must lie inside the cache (non-ring)."""
    b, smax = cache.q.shape[:2]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        if new.shape[1] != 1:
            raise ValueError("per-slot positions insert one token per slot")
        if pos.shape != (b,) or pos.dtype.is_floating_point:
            raise ValueError(f"per-slot positions must be a ({b},) integer "
                             f"tensor, got {pos.dtype} {tuple(pos.shape)}")
        if bool(((pos < 0) | (pos >= smax)).any()):
            raise ValueError(f"per-slot positions {pos.tolist()} lie outside "
                             f"a cache of {smax}")
        qnew = quantize_kv(new)
        rows = torch.arange(cache.q.shape[0], device=cache.q.device)
        cache.q[rows, pos] = qnew.q[:, 0]
        cache.scale[rows, pos] = qnew.scale[:, 0]
        return cache
    pos, s = int(pos), new.shape[1]
    if pos < 0 or pos + s > smax:
        raise ValueError(f"rows {pos}..{pos + s - 1} lie outside a cache of "
                         f"{smax}")
    qnew = quantize_kv(new)
    cache.q[:, pos:pos + s] = qnew.q
    cache.scale[:, pos:pos + s] = qnew.scale
    return cache


def init_quant_cache(batch: int, smax: int, kh: int, d: int, *,
                     device: Union[str, torch.device]) -> QuantKV:
    """A zeroed :class:`QuantKV`: every scale 0, so every row dequantizes
    to 0."""
    return QuantKV(torch.zeros((batch, smax, kh, d), dtype=torch.int8,
                               device=device),
                   torch.zeros((batch, smax, kh, 1), dtype=torch.float32,
                               device=device))


# ---------------------------------------------------------------------------
# Embedding-matrix row quantization (the int8 storage codec)
# ---------------------------------------------------------------------------
def quantize_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, d) f32 -> (int8 (n, d), fp16 scales (n, 1)).

    Same symmetric per-row scheme as :func:`quantize_kv`.  The scale is
    snapped to its STORED fp16 value — clamped to the fp16 minimum normal
    so tiny-magnitude rows quantize with bounded error instead of decoding
    to zeros off an underflowed scale — and the int8 values are computed
    against that snapped scale.
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
