"""Mixture-of-Experts block: top-k router and sort-based capacity dispatch.

Port of ``repro.models.moe``, step by step:

  1. router logits in x's dtype, an f32 softmax, the top-k experts of each
     token (a stable descending sort, so among equal probabilities the
     lower expert id comes first, as ``jax.lax.top_k`` orders them), gates
     renormalised over the k;
  2. the Switch load-balance loss, ``E * sum(mean prob_e * token frac_e)``;
  3. the (token, slot) assignments flattened token-major and sorted by
     expert, STABLY (so the earlier token keeps the earlier place within
     its expert); each one's position within its expert by a cumulative
     count; assignments at or past the capacity C are dropped (they pass
     through the residual only);
  4. the kept tokens gathered into an (E * C + 1, d) buffer whose last row
     swallows the dropped ones, three batched expert products, and the
     gate-weighted combine.

The combine departs from the reference's scatter-add (``index_add_`` and
its kin use atomics on the card, so two runs could differ in their last
bits): each (token, slot) contribution is put back in token-major order and
the k of a token are summed in a fixed order.  The same sums, so the two
agree to rounding, and the card gives the same bits call after call.

Everything keeps fixed shapes and stays on the tensors' device: no host
wait (no ``.item()``, no ``nonzero``, no boolean-mask indexing).  Decode
passes ``capacity = B * S`` (dropless: the worst case sends every token to
one expert), so each step reads all E experts' weights, as the reference
does; prefill and encode use the config's capacity factor.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.models.layers import dense_init, silu


class Routing(NamedTuple):
    """What :func:`route` decides for the T = B * S tokens of ``x``."""
    probs: torch.Tensor        # (T, E) f32 router probabilities
    expert_ids: torch.Tensor   # (T, K) int64, by descending probability
    gates: torch.Tensor        # (T, K) f32, renormalised over the K
    capacity: int              # C, rows per expert
    order: torch.Tensor        # (T*K,) the stable sort of the flat ids
    slot: torch.Tensor         # (T*K,) buffer row, sorted order (E*C: drop)
    keep: torch.Tensor         # (T*K,) bool, sorted order


def init_moe(d_model: int, d_ff: int, num_experts: int,
             generator: torch.Generator,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """``router`` (d, E), ``gate`` / ``up`` (E, d, ff), ``down`` (E, ff, d),
    drawn by :func:`dense_init`, whose fan-in is ``shape[0]``: E for the
    expert stacks, as in the reference."""
    w = lambda shape, scale=None: dense_init(shape, generator, device,
                                             scale=scale)
    return {"router": w((d_model, num_experts), scale=0.02),
            "gate": w((num_experts, d_model, d_ff)),
            "up": w((num_experts, d_model, d_ff)),
            "down": w((num_experts, d_ff, d_model))}


def top_k_stable(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """The k largest of each row with their indices, equal values in
    ascending index order (``jax.lax.top_k``'s order; ``torch.topk``
    promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def capacity_of(tokens: int, num_experts: int, top_k: int,
                capacity_factor: float) -> int:
    """The reference's factor-derived capacity, the same float expression
    in the same order."""
    return int(max(top_k, tokens * top_k / num_experts * capacity_factor))


def route(params: Mapping[str, torch.Tensor], x: torch.Tensor, *,
          num_experts: int, top_k: int, capacity_factor: float = 1.25,
          capacity: int = 0) -> Routing:
    """Steps 1 and 3 of the module docstring for x (B, S, d).
    ``capacity`` > 0 overrides the factor-derived capacity."""
    b, s, d = x.shape
    t = b * s
    logits = (x.reshape(t, d) @ params["router"].to(x.dtype)).to(
        torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gates, expert_ids = top_k_stable(probs, top_k)             # (T, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    if capacity <= 0:
        capacity = capacity_of(t, num_experts, top_k, capacity_factor)
    flat_expert = expert_ids.reshape(-1)                       # (T*K,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    experts = torch.arange(num_experts, device=x.device)
    onehot = (sorted_expert[:, None] == experts).to(torch.int32)
    pos = onehot.cumsum(0).gather(1, sorted_expert[:, None])[:, 0] - 1
    keep = pos < capacity
    slot = torch.where(keep, sorted_expert * capacity + pos,
                       num_experts * capacity)
    return Routing(probs, expert_ids, gates, capacity, order, slot, keep)


def moe_block(params: Mapping[str, torch.Tensor], x: torch.Tensor, *,
              num_experts: int, top_k: int, capacity_factor: float = 1.25,
              capacity: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), the load-balance loss, an f32
    scalar).  ``params``: ``router``, ``gate``, ``up``, ``down`` as
    :func:`init_moe` makes them; ``capacity`` > 0 overrides the factor
    (serving's decode passes B * S, dropless)."""
    b, s, d = x.shape
    t, dtype = b * s, x.dtype
    r = route(params, x, num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor, capacity=capacity)
    c = r.capacity

    # load-balance aux loss (Switch eq. 4)
    experts = torch.arange(num_experts, device=x.device)
    me = r.probs.mean(0)                                   # router mass
    ce = (r.expert_ids[..., None] == experts).to(torch.float32).sum(1) \
        .mean(0) / top_k                                   # token fraction
    aux = num_experts * (me * ce).sum()

    # dispatch: the kept tokens into (E*C + 1, d); the last row takes drops
    xf = x.reshape(t, d)
    sorted_token = torch.div(r.order, top_k, rounding_mode="floor")
    buf = x.new_zeros((num_experts * c + 1, d))
    buf[r.slot] = xf[sorted_token]
    buf = buf[:-1].view(num_experts, c, d)

    # expert FFN, batched over experts
    h = silu(torch.bmm(buf, params["gate"].to(dtype)))
    h = h * torch.bmm(buf, params["up"].to(dtype))
    y = torch.bmm(h, params["down"].to(dtype)).reshape(num_experts * c, d)
    y = torch.cat([y, y.new_zeros((1, d))])

    # combine: each (token, slot)'s buffer row back in token-major order,
    # the k contributions of a token summed in a fixed order
    slot_tok = torch.empty_like(r.slot)
    slot_tok[r.order] = r.slot
    keep_tok = slot_tok < num_experts * c
    contrib = y[slot_tok] * (r.gates.reshape(-1).to(dtype)
                             * keep_tok.to(dtype))[:, None]
    out = contrib.view(t, top_k, d).sum(1)
    return out.reshape(b, s, d), aux
