"""Plain PyTorch version of ``slab_topk`` (fp32 slabs).

Contract (as ``repro.kernels.slab_topk.ref``): the batch's unique probed
clusters are packed once into ``emb`` (N, D); ``virt`` (Q, N) int32 holds,
for each (query, row), the row's position in that query's virtual per-query
concatenation, or :data:`NOT_PROBED` when the query did not probe the row's
cluster.  Per query, the best k rows by (score desc, virt asc); rows that
are not members score :data:`NEG_INF` and come last in row order.  The
virt tie-break makes the ids equal to a top-k over the per-query concat.

Scores come from :func:`~repro_torch.kernels.ivf_topk.ref.scores_fixed_order`
(batch-invariant, see there); selection is two stable sorts, so the order
is exactly (score desc, virt asc, row asc), +0.0 and -0.0 tied.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ivf_topk.ref import scores_fixed_order

NOT_PROBED = 2**30          # virt sentinel: row not in this query's probe set
NEG_INF = -1e30


def lex_topk(masked: torch.Tensor, tie: torch.Tensor, k: int):
    """Best k columns per row of ``masked`` (Q, N) by (value desc, tie asc,
    column asc) -> (values (Q, k), columns (Q, k) int32)."""
    by_tie = torch.sort(tie, dim=1, stable=True).indices
    key = (masked + 0.0).gather(1, by_tie)       # -0.0 -> +0.0: zeros tie
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    cols = by_tie.gather(1, order[:, :k])
    return masked.gather(1, cols), cols.to(torch.int32)


def slab_topk_ref(emb: torch.Tensor, queries: torch.Tensor,
                  virt: torch.Tensor, k: int):
    """emb (N, D) f32, queries (Q, D), virt (Q, N) int32 -> (vals (Q, k)
    f32, rows (Q, k) int32); requires k <= N (the wrapper clamps)."""
    member = virt < NOT_PROBED
    scores = scores_fixed_order(emb, queries)
    masked = torch.where(member, scores, NEG_INF)
    tie = torch.where(member, virt, NOT_PROBED)
    return lex_topk(masked, tie, k)
