"""Plain PyTorch versions of ``flash_attention`` and of its gradient.

Contract (as ``repro.kernels.flash_attention.ref``, head-major): q (B, H,
Sq, D), k / v (B, KH, Skv, D), H % KH == 0 -> (B, H, Sq, D) in q's dtype.
Scores (q . k) * D^-0.5 in f32; the causal mask keeps k <= q and a window
> 0 keeps k > q - window, with positions counted from 0 for q and for k;
masked scores are -1e30 before the softmax, so a row whose every key is
masked (a window, and q >= Skv + window - 1) takes the mean of V.

:func:`flash_attention_bwd_ref` is the gradient by its explicit formula
(not autograd), in the same layout: the kernel's plain version
(``csrc/flash_attention_bwd.cu``), equal to ``jax.grad`` of the JAX
package's ``flash_attention_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def _keep(sq: int, skv: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """(Sq, Skv) bool: the (query, key) pairs the masks keep."""
    qp = torch.arange(sq, device=device)
    kp = torch.arange(skv, device=device)
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kp[None, :] <= qp[:, None]
    if window:
        ok &= kp[None, :] > qp[:, None] - window
    return ok


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(masked f32 scores (B, H, Sq, Skv), the keep mask, k repeated over
    each kv head's query heads in f32)."""
    d = q.shape[-1]
    k = torch.repeat_interleave(k, q.shape[1] // k.shape[1],
                                dim=1).to(torch.float32)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k) \
        * d ** -0.5
    ok = _keep(q.shape[2], k.shape[2], causal, window, q.device)
    return torch.where(ok, scores, NEG_INF), ok, k


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    rep = q.shape[1] // k.shape[1]
    v = torch.repeat_interleave(v, rep, dim=1).to(torch.float32)
    scores, _, _ = _scores(q, k, causal, window)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """(B, H, Sq) f32: each row's log-sum-exp of its masked scores, the
    ``lse`` the kernel writes beside its output (a row with no valid key
    gets -1e30 + log(Skv), which is -1e30 in f32; the backward does not
    read it)."""
    scores, _, _ = _scores(q, k, causal, window)
    return torch.logsumexp(scores, dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_ref` at (q, k, v), given its
    output ``out``, the rows' ``lse`` (B, H, Sq) and the output's gradient
    ``dout`` (B, H, Sq, D), in f32, cast to the inputs' dtypes:

    - P = exp(S - lse) where the masks keep (i, j), else 0; a row with no
      valid key has the uniform P = 1 / Skv that the forward gives it;
    - dV = P^T dO, dP = dO V^T, Di = rowsum(dO o O), dS = P o (dP - Di)
      where the masks keep (i, j), else 0 (masked scores are constants);
    - dQ = dS K D^-0.5, dK = dS^T Q D^-0.5;
    - dK and dV summed over the H / KH query heads of each kv head."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    rep = h // kh
    scores, ok, kf = _scores(q, k, causal, window)
    vf = torch.repeat_interleave(v, rep, dim=1).to(torch.float32)
    dead = ~ok.any(dim=-1, keepdim=True)                        # (Sq, 1)
    p = torch.where(ok, torch.exp(scores - lse[..., None]),
                    torch.where(dead, 1.0 / skv, 0.0))
    do, o = dout.to(torch.float32), out.to(torch.float32)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    di = (do * o).sum(dim=-1, keepdim=True)
    ds = torch.where(ok, p * (dp - di), 0.0)
    scale = d ** -0.5
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(torch.float32)) * scale
    dk = dk.view(b, kh, rep, skv, d).sum(dim=2)
    dv = dv.view(b, kh, rep, skv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
