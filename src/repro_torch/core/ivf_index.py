"""Two-level Inverted File (IVF) index — the paper's latency baseline
(Table 4 row 2) and the substrate EdgeRAG modifies.

Port of ``repro.core.ivf_index``.  Level 1: cluster centroids, always
resident.  Level 2: per-cluster chunk embeddings, resident in memory for
the baseline.  Both are fp32 tensors on the index's ``device`` (the card
unless ``device="cpu"``); the chunk ids stay on the host.  Retrieval probes
the ``nprobe`` nearest centroids (one ``topk_ip`` call) and scans their
clusters, concatenated on the device (one more).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.costs import EdgeCostModel, LatencyBreakdown, WallTimer
from repro_torch.core.kmeans import kmeans
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ivf_topk.ops import topk_ip


@dataclasses.dataclass
class Cluster:
    ids: np.ndarray                       # (n,) chunk ids
    embeddings: Optional[torch.Tensor]    # (n, d) or None when pruned

    @property
    def size(self) -> int:
        return len(self.ids)


class IVFIndex:
    def __init__(self, dim: int, cost_model: Optional[EdgeCostModel] = None,
                 *, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dim = dim
        self.cost = cost_model or EdgeCostModel()
        self.centroids: Optional[torch.Tensor] = None        # (nlist, d)
        self.clusters: List[Cluster] = []

    # ------------------------------------------------------------------
    def build(self, embeddings: np.ndarray, ids: np.ndarray,
              nlist: int, kmeans_iters: int = 20, seed: int = 0):
        embeddings = np.ascontiguousarray(embeddings, np.float32)
        centroids, assign = kmeans(embeddings, nlist, iters=kmeans_iters,
                                   seed=seed, device=self.device)
        self._install(centroids, assign, ids, embeddings)
        return assign

    def _install(self, centroids: np.ndarray, assign: np.ndarray,
                 ids: np.ndarray, embeddings: np.ndarray):
        """Index ``embeddings`` under GIVEN centroids and cluster
        assignments (``build`` after its k-means; ``convert`` loads another
        index's clustering this way)."""
        embeddings = np.ascontiguousarray(embeddings, np.float32)
        ids = np.asarray(ids, np.int64)
        assign = np.asarray(assign)
        self.centroids = torch.from_numpy(
            np.array(centroids, np.float32)).to(self.device)
        self.clusters = []
        for c in range(self.centroids.shape[0]):
            sel = np.where(assign == c)[0]
            self.clusters.append(
                Cluster(ids=ids[sel], embeddings=torch.from_numpy(
                    np.ascontiguousarray(embeddings[sel])).to(self.device)))

    @property
    def nlist(self) -> int:
        return 0 if self.centroids is None else len(self.centroids)

    @property
    def ntotal(self) -> int:
        return sum(c.size for c in self.clusters)

    def memory_bytes(self) -> int:
        n = self.centroids.nbytes if self.centroids is not None else 0
        for c in self.clusters:
            if c.embeddings is not None:
                n += c.embeddings.nbytes
        return n

    # ------------------------------------------------------------------
    def probe(self, query: np.ndarray, nprobe: int) -> np.ndarray:
        """(Q, d) -> (Q, nprobe) centroid indices."""
        query = np.atleast_2d(np.asarray(query, np.float32))
        _, idx = topk_ip(self.centroids,
                         torch.from_numpy(query).to(self.device),
                         min(nprobe, self.nlist))
        return idx.cpu().numpy()

    def search(self, query: np.ndarray, k: int, nprobe: int
               ) -> Tuple[np.ndarray, np.ndarray, LatencyBreakdown]:
        """Single query (d,) or (1, d)."""
        query = np.atleast_2d(np.asarray(query, np.float32))
        assert query.shape[0] == 1, "IVF search is per-query"
        lat = LatencyBreakdown()
        with WallTimer() as t:
            probed = self.probe(query, nprobe)[0]
            lat.n_clusters_probed = len(probed)
            cand_embs, cand_ids, scanned = [], [], 0
            for c in probed:
                cl = self.clusters[int(c)]
                if cl.size == 0 or cl.embeddings is None:
                    continue
                cand_embs.append(cl.embeddings)
                cand_ids.append(cl.ids)
                scanned += cl.size
            if not cand_embs:
                empty = np.full((1, k), -1, np.int64)
                return empty, np.full((1, k), -np.inf, np.float32), lat
            embs = torch.cat(cand_embs)
            idmap = np.concatenate(cand_ids)
            vals, idx = topk_ip(embs, torch.from_numpy(query).to(self.device),
                                k)
            # the copy back waits for the kernel, inside the timed window
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        lat.wall_s = t.elapsed
        lat.centroid_search_s = (
            self.cost.mem_load_latency(self.centroids.nbytes)
            + self.cost.search_latency(self.nlist, self.dim))
        # level-2: touched cluster embeddings load from "memory"; the
        # RESIDENT SET is the whole in-memory index (this is what thrashes)
        lat.l2_mem_load_s = self.cost.mem_load_latency(
            embs.nbytes, resident_bytes=self.memory_bytes())
        lat.l2_search_s = self.cost.search_latency(scanned, self.dim)
        ids = np.where(idx >= 0, idmap[np.clip(idx, 0, len(idmap) - 1)], -1)
        return ids, vals, lat
