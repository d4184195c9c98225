"""Hand-written AdamW and the cosine schedule, as plain functions on tensors.

Port of ``repro.train.optimizer``, with its arithmetic kept:

- the global norm is the square root of the sum of every gradient's sum
  of squares, in f32;
- gradients are scaled by ``min(1, clip_norm / max(gnorm, 1e-9))``;
- the bias corrections come from the incremented count;
- each parameter becomes ``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``.

``torch.optim.AdamW`` and ``clip_grad_norm_`` round and clip otherwise
(``clip_grad_norm_`` divides by ``total_norm + 1e-6``), so neither is used.
The moments and the parameters are updated in place, one parameter at a
time (:func:`adamw_update`), which saves a copy of the model and of each
moment: at stablelm-1.6b's 1.64 B parameters each is 6.6 GB.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import torch


class AdamWState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int


def adamw_init(params: Sequence[torch.Tensor]) -> AdamWState:
    """Zero moments beside each parameter, count 0."""
    return AdamWState(mu=[torch.zeros_like(p) for p in params],
                      nu=[torch.zeros_like(p) for p in params], count=0)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum over tensors of sum(t ** 2)), an f32 scalar on their
    device."""
    sums = [torch.sum(torch.square(t.to(torch.float32))) for t in tensors]
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def adamw_update(grads: Sequence[torch.Tensor], state: AdamWState,
                 params: Sequence[torch.Tensor], *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0
                 ) -> tuple:
    """One AdamW step on ``params`` IN PLACE.  Returns (params, the new
    state, the gradients' global norm before clipping, an f32 scalar).
    ``grads`` are scaled in place when clipped."""
    params, grads = list(params), list(grads)
    gnorm = global_norm(grads)
    if clip_norm:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        torch._foreach_mul_(grads, scale)
    count = state.count + 1
    # the reference's f32 count, its bias corrections in f32
    cf = torch.tensor(float(count), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** cf)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** cf)
    # one parameter at a time: the temporaries stay one tensor's size
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        m.mul_(b1).add_(g * (1 - b1))               # b1 m + (1 - b1) g
        v.mul_(b2).add_(g * g * (1 - b2))           # b2 v + (1 - b2) g^2
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p
        p.sub_(lr * upd)
    return params, AdamWState(mu=state.mu, nu=state.nu, count=count), \
        gnorm


def cosine_schedule(step: int, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1) -> float:
    """Linear warmup from 0 over ``warmup`` steps (step 0's lr is 0), then
    a cosine from ``peak_lr`` down to ``floor * peak_lr`` at ``total``;
    computed in f32 as the reference computes it."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    s = f(step)
    if step < warmup:
        return float(peak_lr * s / max(warmup, 1))
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(
        f(math.pi) * frac)))
    return float(cos)
