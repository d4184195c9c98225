"""Decode-time caches: KV caches for attention blocks, full and circular
(sliding-window) ring buffers, and the RWKV6 and Mamba2 states.

Port of ``repro.models.cache`` for every block kind; the JAX package's
``window_mode`` (every attention layer a ring at the long-context serving
window) comes with the slice that needs it.  One cache per layer, in the
order of ``cfg.block_pattern`` repeated: a :class:`KVCache` (B, size, KH,
D) for an attention layer (each application of a ``"shared_attn"`` block
its own, of ``max_len`` rows), an
:class:`~repro_torch.models.rwkv6.RwkvCache` for an ``"rwkv6"`` layer and
a :class:`~repro_torch.models.mamba2.MambaCache` for a ``"mamba2"`` layer
(both sized independently of ``max_len``).  Unlike the JAX package's
immutable caches, all are written IN PLACE (no copy of the whole cache per
decoded token), and a KV cache carries whether it is a ring (the JAX
package derives it from the block kind at every call).

A ring of ``size`` rows keeps token p at row ``p % size``: its last
``size`` tokens, which are exactly a window of ``size`` tokens.  So a
decode length of ``size`` or more makes every row valid, and attending
over a ring needs no window mask.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba2 import MambaCache, init_mamba_cache
from repro_torch.models.rwkv6 import RwkvCache, init_rwkv_cache

Cache = Union["KVCache", RwkvCache, MambaCache]


class KVCache:
    def __init__(self, k: torch.Tensor, v: torch.Tensor, *,
                 circular: bool = False):
        self.k = k          # (B, size, KH, D)
        self.v = v
        self.circular = circular

    @property
    def nbytes(self) -> int:
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())

    def fresh_row(self, slot: int) -> "KVCache":
        """Zeroes ``slot``'s row and returns a one-row cache of views of it
        (a prefill into it writes the batched cache)."""
        self.k[slot].zero_()
        self.v[slot].zero_()
        return KVCache(self.k[slot:slot + 1], self.v[slot:slot + 1],
                       circular=self.circular)

    def insert(self, k_new: torch.Tensor, v_new: torch.Tensor,
               pos: Union[int, torch.Tensor]) -> "KVCache":
        """Write (B, S_new, KH, D) in place: at position ``pos`` in every
        slot, or, for a (B,) tensor ``pos`` (S_new == 1), slot b's one
        token at ``pos[b]``.  A ring writes at ``pos % size``."""
        if self.circular:
            pos = pos % self.k.shape[1]
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

    def prefill(self, k: torch.Tensor, v: torch.Tensor) -> "KVCache":
        """Write a prompt's (B, S, KH, D) from position 0, in place.  A ring
        shorter than the prompt keeps its last ``size`` tokens, token p at
        row ``p % size`` (the JAX model's prefill scatter)."""
        size, s = self.k.shape[1], k.shape[1]
        if not self.circular or s <= size:
            return self.insert(k, v, 0)
        rows = torch.arange(s - size, s, device=self.k.device) % size
        self.k[:, rows] = k[:, -size:].to(self.k.dtype)
        self.v[:, rows] = v[:, -size:].to(self.v.dtype)
        return self


def kv_cache_spec(cfg: ModelConfig, kind: str,
                  max_len: int) -> Tuple[int, bool]:
    """(rows, circular) of a layer of block ``kind``: an ``"swa"`` or
    ``"swa_moe"`` layer of a config with a window is a ring of
    ``min(window, max_len)`` rows."""
    if kind in ("swa", "swa_moe") and cfg.sliding_window:
        return min(cfg.sliding_window, max_len), True
    return max_len, False


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device, dtype=torch.float32) -> List[Cache]:
    """One zeroed cache per layer, sized by the layer's kind."""
    pattern = cfg.block_pattern
    caches = []
    for layer in range(cfg.num_layers):
        kind = pattern[layer % len(pattern)]
        if kind == "rwkv6":
            caches.append(init_rwkv_cache(cfg, batch, device=device,
                                          dtype=dtype))
            continue
        if kind == "mamba2":
            caches.append(init_mamba_cache(cfg, batch, device=device,
                                           dtype=dtype))
            continue
        size, circular = kv_cache_spec(cfg, kind, max_len)
        shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
        caches.append(KVCache(torch.zeros(shape, dtype=dtype, device=device),
                              torch.zeros(shape, dtype=dtype, device=device),
                              circular=circular))
    return caches


def cache_bytes(caches: List[Cache]) -> int:
    return sum(c.nbytes for c in caches)
