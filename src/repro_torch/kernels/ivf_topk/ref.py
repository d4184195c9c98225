"""Plain PyTorch version of ``ivf_topk``: top-k inner-product search.

Contract (as ``repro.kernels.ivf_topk.ref``): embeddings (N, D) and queries
(Q, D) -> the top-k scores and row indices per query, best first, ties to
the lower index.

Both functions here are batch-invariant: every (query, row) score is the
same elementwise-product sum over D whatever Q and N are, because each sum
runs on a tile of one fixed shape (one query against ``SCORE_CHUNK`` rows,
the last tile zero-padded).  A ``matmul`` would not do: its blocking, and so
its summation order, changes with Q.  Selection is a stable sort, so ties
keep index order (``torch.topk`` promises no order among ties).
"""
from __future__ import annotations

import torch

SCORE_CHUNK = 256


def scores_fixed_order(embs: torch.Tensor, queries: torch.Tensor,
                       chunk: int = SCORE_CHUNK) -> torch.Tensor:
    """(Q, N) f32 inner products, each a fixed-shape sum over D."""
    e = embs.to(torch.float32)
    q = queries.to(torch.float32)
    n, d = e.shape
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=e.device)
    for start in range(0, n, chunk):
        tile = e[start:start + chunk]
        rows = tile.shape[0]
        if rows < chunk:
            tile = torch.cat([tile, tile.new_zeros((chunk - rows, d))])
        for qi in range(q.shape[0]):
            out[qi, start:start + rows] = (tile * q[qi]).sum(-1)[:rows]
    return out


def topk_ip_ref(embs: torch.Tensor, queries: torch.Tensor, k: int):
    """embs (N, D), queries (Q, D) -> (vals (Q, k) f32, idx (Q, k) int32);
    requires k <= N (the wrapper clamps)."""
    scores = scores_fixed_order(embs, queries)
    # + 0.0 turns -0.0 into +0.0, so signed zeros tie and keep index order
    order = torch.sort(scores + 0.0, dim=1, descending=True,
                       stable=True).indices[:, :k]
    return scores.gather(1, order), order.to(torch.int32)
