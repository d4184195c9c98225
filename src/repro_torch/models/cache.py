"""Decode-time KV caches for dense attention blocks.

Port of ``repro.models.cache`` for the full (non-ring) cache of ``"attn"``
blocks; ring buffers and SSM states come with the slices that need them.
One :class:`KVCache` per layer, each (B, Smax, KH, D).  Unlike the JAX
package's immutable caches, :meth:`KVCache.insert` writes IN PLACE (no copy
of the whole cache per decoded token).
"""
from __future__ import annotations

from typing import List, Union

import torch

from repro_torch.configs.base import ModelConfig


class KVCache:
    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k          # (B, Smax, KH, D)
        self.v = v

    def insert(self, k_new: torch.Tensor, v_new: torch.Tensor,
               pos: Union[int, torch.Tensor]) -> "KVCache":
        """Write (B, S_new, KH, D) in place: at position ``pos`` in every
        slot, or, for a (B,) tensor ``pos`` (S_new == 1), slot b's one
        token at ``pos[b]``."""
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            if k_new.shape[1] != 1:
                raise ValueError("per-slot positions insert one token per "
                                 "slot")
            rows = torch.arange(self.k.shape[0], device=self.k.device)
            self.k[rows, pos] = k_new[:, 0].to(self.k.dtype)
            self.v[rows, pos] = v_new[:, 0].to(self.v.dtype)
            return self
        s = k_new.shape[1]
        self.k[:, pos:pos + s] = k_new.to(self.k.dtype)
        self.v[:, pos:pos + s] = v_new.to(self.v.dtype)
        return self


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device, dtype=torch.float32) -> List[KVCache]:
    """One zeroed :class:`KVCache` per layer."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [KVCache(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_layers)]


def cache_bytes(caches: List[KVCache]) -> int:
    return sum(c.k.numel() * c.k.element_size()
               + c.v.numel() * c.v.element_size() for c in caches)
