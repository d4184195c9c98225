"""Plain PyTorch version of ``decode_attention``: one query token against a
KV cache, in f32.

Contract (as ``repro.kernels.decode_attention.ref``, with per-slot lengths
as the model's ``attend_decode`` takes them): q (B, H, D), k / v cache (B,
Smax, KH, D), H % KH == 0, ``lengths`` an int or a (B,) integer tensor.
Position j of slot b is valid when j < lengths[b] and, with a window > 0,
j > lengths[b] - 1 - window (a length >= Smax makes every position valid).
Scores (q . k) * D^-0.5 in f32, -1e30 where invalid, softmax, then the
weighted sum of V -> (B, H, D) in q's dtype.

``decode_attention_q8_ref`` is the same over an int8 cache with f32 scales
(B, Smax, KH, 1) per (token, kv head), as ``repro.models.quantization``
stores it: K and V dequantized (``k_q.float() * k_scale``), then the same
arithmetic.
"""
from __future__ import annotations

from typing import Union

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: Union[int, torch.Tensor], *,
                         window: int = 0) -> torch.Tensor:
    b, h, d = q.shape
    rep = h // k_cache.shape[2]
    k = torch.repeat_interleave(k_cache, rep, dim=2).to(torch.float32)
    v = torch.repeat_interleave(v_cache, rep, dim=2).to(torch.float32)
    scores = torch.einsum("bhd,bshd->bhs", q.to(torch.float32), k) \
        * d ** -0.5
    idx = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    lens = torch.as_tensor(lengths, device=q.device).reshape(-1, 1)
    valid = idx < lens                                     # (B | 1, Smax)
    if window:
        valid &= idx > lens - 1 - window
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", probs, v).to(q.dtype)


def decode_attention_q8_ref(q: torch.Tensor, k_q: torch.Tensor,
                            k_scale: torch.Tensor, v_q: torch.Tensor,
                            v_scale: torch.Tensor,
                            lengths: Union[int, torch.Tensor], *,
                            window: int = 0) -> torch.Tensor:
    return decode_attention_ref(q, k_q.to(torch.float32) * k_scale,
                                v_q.to(torch.float32) * v_scale, lengths,
                                window=window)
