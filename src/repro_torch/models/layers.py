"""Shared layers: RMSNorm, SwiGLU MLP, RoPE (standard and qwen2-vl's
M-RoPE), as plain functions on tensors.

Port of ``repro.models.layers``.
Weights keep the JAX package's (in, out) layout, so a projection is
``x @ w``.  Init mirrors llama-family conventions (truncated-normal
projections scaled by fan-in, zeros for the ``1 + w`` norms), drawn from an
explicit ``torch.Generator``.
"""
from __future__ import annotations

import numpy as np
import torch


def dense_init(shape, generator: torch.Generator, device: torch.device,
               scale=None) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (default 1/sqrt(fan_in)),
    drawn on ``device`` from ``generator`` (which must live there too)."""
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(scale)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """Scales by ``1 + weight`` (gemma-style): zero init is the identity."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + weight.to(torch.float32))).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x).  Below f32 each op rounds to x's
    dtype, and XLA's sigmoid is 1 / (1 + exp(-x)), so that is what runs
    there (bitwise the reference's bf16 silu; ``torch``'s fused op rounds
    once and differs in ~40% of bf16 elements); f32 keeps the fused op."""
    if x.dtype == torch.float32:
        return torch.nn.functional.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def mlp(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x @ gate) * (x @ up)) @ down``, each weight cast to
    x's dtype for its product, as the reference does."""
    h = silu(x @ gate.to(x.dtype)) * (x @ up.to(x.dtype))
    return h @ down.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """(head_dim // 2,) inverse frequencies, float32 as in the JAX package."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor):
    """Rotary embedding on the two HALVES of the head dim (not interleaved).

    x: (B, S, H, D); positions: (B, S) integer; ``inv_freq``: the
    (D // 2,) :func:`rope_frequencies` already on x's device (a host copy
    per call would stall the host on the device every layer)."""
    angles = positions[..., None].to(torch.float32) * inv_freq  # (B,S,D/2)
    return _rotate(x, angles)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                inv_freq: torch.Tensor, sections):
    """Multimodal RoPE (qwen2-vl, arXiv:2409.12191).

    positions: (3, B, S) integer, the temporal / height / width streams;
    ``sections`` partitions the D // 2 frequency bands among the three
    streams, in order, and each band rotates by its stream's position.
    The reference picks a band's stream by a one-hot contraction; here
    each stream's slice of ``inv_freq`` multiplies that stream's
    positions, the same products, so equal streams give
    :func:`apply_rope`'s result bitwise."""
    if sum(sections) != inv_freq.shape[0]:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {inv_freq.shape[0]}")
    pos = positions.to(torch.float32)
    angles = torch.cat([pos[i][..., None] * f for i, f in
                        enumerate(torch.split(inv_freq, list(sections)))],
                       dim=-1)                              # (B, S, D/2)
    return _rotate(x, angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotates x (B, S, H, D) by ``angles`` (B, S, D // 2)."""
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return torch.tanh(logits / cap) * cap
    return logits
