"""GQA attention in plain PyTorch: reference, chunked (online softmax), decode.

Port of ``repro.models.attention``.  The JAX model computes attention in
``jnp`` outside any Pallas kernel, and so does this module (einsum and
softmax; no fused library attention): it is what the model runs on the CPU.
On the card the model runs the hand-written kernels instead
(``repro_torch.kernels.flash_attention`` for prefill and encode,
``repro_torch.kernels.decode_attention`` for decode).

All functions take q (B, Sq, H, D), k / v (B, Skv, KH, D) with H % KH == 0
and return (B, Sq, H, D).  Masks: ``causal`` plus an optional ``window``
(sliding, in tokens).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import softcap

NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """(B, S, KH, D) -> (B, S, H, D) by repeating each kv head."""
    rep = num_q_heads // k.shape[2]
    return k if rep == 1 else torch.repeat_interleave(k, rep, dim=2)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(Sq, Skv) additive bias from positions."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window and window > 0:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF)


def attend_reference(q, k, v, *, causal=True, window=0, logit_cap=0.0,
                     q_offset=0):
    """Quadratic reference.  q_offset: absolute position of q[0] vs k[0]."""
    b, sq, h, d = q.shape
    k = _expand_kv(k, h).to(torch.float32)
    v = _expand_kv(v, h).to(torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k) \
        * d ** -0.5
    scores = softcap(scores, logit_cap)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(k.shape[1], device=q.device)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.to(q.dtype)


def attend_chunked(q, k, v, *, causal=True, window=0, logit_cap=0.0,
                   block_kv=512, q_offset=0):
    """Online softmax over KV blocks: O(Sq * block_kv) score memory."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qf = q.to(torch.float32) * d ** -0.5
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, h, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for start in range(0, skv, block_kv):
        kblk = _expand_kv(k[:, start:start + block_kv], h).to(torch.float32)
        vblk = _expand_kv(v[:, start:start + block_kv], h).to(torch.float32)
        scores = softcap(torch.einsum("bqhd,bkhd->bhqk", qf, kblk),
                         logit_cap)
        k_pos = start + torch.arange(kblk.shape[1], device=q.device)
        scores = scores + _mask_bias(q_pos, k_pos, causal, window)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attend_decode(q, k_cache, v_cache, cache_len, *, window=0,
                  logit_cap=0.0, circular=False):
    """One-token decode: q (B, 1, H, D) against a cache (B, Smax, KH, D).
    ``cache_len`` (an int, or (B,) per-slot lengths) counts the valid
    tokens INCLUDING the current one (the caller inserts its k / v before
    attending).  ``circular``: the cache is a ring buffer of Smax rows, its
    rows valid up to ``min(cache_len, Smax)`` and the window ignored (the
    ring holds the window)."""
    b, sq, h, d = q.shape
    assert sq == 1
    k = _expand_kv(k_cache, h).to(torch.float32)
    v = _expand_kv(v_cache, h).to(torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * d ** -0.5,
                          k)
    scores = softcap(scores, logit_cap)
    idx = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    if circular:
        valid = idx < torch.clamp(clen, max=k_cache.shape[1])
    else:
        valid = idx < clen                                 # (B | 1, Smax)
        if window and window > 0:
            valid &= idx > (clen - 1 - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.to(q.dtype)
