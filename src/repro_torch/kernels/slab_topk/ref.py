"""Plain PyTorch version of ``slab_topk`` (fp32, fp16, int8 and PQ slabs).

Contract (as ``repro.kernels.slab_topk.ref``): the batch's unique probed
clusters are packed once into ``emb`` (N, D); ``virt`` (Q, N) int32 holds,
for each (query, row), the row's position in that query's virtual per-query
concatenation, or :data:`NOT_PROBED` when the query did not probe the row's
cluster.  Per query, the best k rows by (score desc, virt asc); rows that
are not members score :data:`NEG_INF` and come last in row order.  The
virt tie-break makes the ids equal to a top-k over the per-query concat.

Scores per mode:
  fp32 / fp16  :func:`~repro_torch.kernels.ivf_topk.ref.scores_fixed_order`
               (batch-invariant; fp16 is widened to f32 first, exactly);
  int8         the same f32 dot of the widened int8 values, then times the
               row's f32 scale — one multiply per score, after the dot;
  pq           :func:`pq_adc_scores`: ``emb`` is the (N, m) uint8 code
               matrix and ``luts`` (Q, m, 256) the per-query ADC tables;
               the score is ``sum_j luts[q, j, codes[r, j]]`` from 0.0, j
               ascending.
Selection is two stable sorts, so the order is exactly (score desc, virt
asc, row asc), +0.0 and -0.0 tied.
"""
from __future__ import annotations

from typing import Optional

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


def pq_adc_scores(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes (N, m) uint8, luts (Q, m, 256) f32 -> (Q, N) f32 with
    ``out[q, r] = sum_j luts[q, j, codes[r, j]]``, accumulated from 0.0 in
    ascending j (the order the JAX reference and the CUDA kernel use)."""
    codes = codes.long()
    acc = torch.zeros((luts.shape[0], codes.shape[0]), dtype=torch.float32,
                      device=luts.device)
    for j in range(codes.shape[1]):
        acc = acc + luts[:, j, :].float()[:, codes[:, j]]
    return acc


def slab_scores(emb: torch.Tensor, queries: torch.Tensor,
                scales: Optional[torch.Tensor] = None,
                luts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, N) f32 scores of every (query, row) pair in the slab's mode."""
    if luts is not None:
        return pq_adc_scores(emb, luts)
    scores = scores_fixed_order(emb, queries)
    if scales is not None:
        scores = scores * scales.float()[:, 0][None, :]
    return scores


def slab_topk_ref(emb: torch.Tensor, queries: torch.Tensor,
                  virt: torch.Tensor, k: int, *,
                  scales: Optional[torch.Tensor] = None,
                  luts: Optional[torch.Tensor] = None):
    """emb (N, D) f32 / f16 / int8 (+ ``scales`` (N, 1) f32) or (N, m)
    uint8 codes (+ ``luts`` (Q, m, 256) f32), queries (Q, D) f32, virt
    (Q, N) int32 -> (vals (Q, k) f32, rows (Q, k) int32); requires k <= N
    (the wrapper clamps)."""
    member = virt < NOT_PROBED
    masked = torch.where(member, slab_scores(emb, queries, scales, luts),
                         NEG_INF)
    tie = torch.where(member, virt, NOT_PROBED)
    return lex_topk(masked, tie, k)
