"""Plain PyTorch version of ``flash_attention``: GQA attention in f32.

Contract (as ``repro.kernels.flash_attention.ref``, head-major): q (B, H,
Sq, D), k / v (B, KH, Skv, D), H % KH == 0 -> (B, H, Sq, D) in q's dtype.
Scores (q . k) * D^-0.5 in f32; the causal mask keeps k <= q and a window
> 0 keeps k > q - window, with positions counted from 0 for q and for k;
masked scores are -1e30 before the softmax.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    b, h, sq, d = q.shape
    rep = h // k.shape[1]
    k = torch.repeat_interleave(k, rep, dim=1).to(torch.float32)
    v = torch.repeat_interleave(v, rep, dim=1).to(torch.float32)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k) \
        * d ** -0.5
    qp = torch.arange(sq, device=q.device)
    kp = torch.arange(k.shape[2], device=q.device)
    ok = torch.ones((sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp[None, :] <= qp[:, None]
    if window:
        ok &= kp[None, :] > qp[:, None] - window
    scores = torch.where(ok, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).to(q.dtype)
