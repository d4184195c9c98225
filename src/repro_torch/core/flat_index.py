"""Flat (exhaustive) index — the paper's quality baseline (Table 4 row 1).

Port of ``repro.core.flat_index``.  Every chunk embedding is held as one
fp32 tensor on the index's ``device`` (the card unless ``device="cpu"``),
and each search is one ``topk_ip`` call over all of it: the ``ivf_topk``
kernel on the card, its plain version on the CPU.  The baseline's premise
is that the whole index is resident, so nothing goes back to the host
between searches but the (Q, k) results.

Retrieval is exact; the cost model charges the full resident set (which is
what thrashes on edge devices once the index outgrows DRAM — Fig. 3).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.costs import EdgeCostModel, LatencyBreakdown, WallTimer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ivf_topk.ops import topk_ip


class FlatIndex:
    def __init__(self, dim: int, cost_model: Optional[EdgeCostModel] = None,
                 *, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dim = dim
        self.cost = cost_model or EdgeCostModel()
        self._embs: Optional[torch.Tensor] = None     # (N, dim) f32, resident
        self._ids: Optional[np.ndarray] = None        # (N,) chunk ids, host

    def add(self, embeddings: np.ndarray, ids: np.ndarray):
        embeddings = torch.from_numpy(
            np.array(embeddings, np.float32)).to(self.device)
        ids = np.asarray(ids, np.int64)
        if self._embs is None:
            self._embs, self._ids = embeddings, ids
        else:
            self._embs = torch.cat([self._embs, embeddings])
            self._ids = np.concatenate([self._ids, ids])

    @property
    def ntotal(self) -> int:
        return 0 if self._embs is None else len(self._embs)

    def memory_bytes(self) -> int:
        return 0 if self._embs is None else self._embs.nbytes

    def search(self, query: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray, LatencyBreakdown]:
        """query (Q, dim) -> (ids (Q,k), scores (Q,k), latency)."""
        query = np.atleast_2d(np.asarray(query, np.float32))
        lat = LatencyBreakdown()
        with WallTimer() as t:
            vals, idx = topk_ip(self._embs,
                                torch.from_numpy(query).to(self.device), k)
            # the copy back waits for the kernel, inside the timed window
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        lat.wall_s = t.elapsed
        # sequential scan touches the whole index; thrashing if over-memory
        lat.l2_mem_load_s = self.cost.mem_load_latency(
            self._embs.nbytes, resident_bytes=self.memory_bytes())
        lat.l2_search_s = self.cost.search_latency(self.ntotal, self.dim)
        ids = np.where(idx >= 0, self._ids[np.clip(idx, 0, self.ntotal - 1)],
                       -1)
        return ids, vals, lat
