"""train_step: loss, gradients and the AdamW update, one call a step.

Port of ``repro.train.train_step``.  The JAX step is a pure function of a
``TrainState`` that ``jax.jit`` donates; here :class:`TrainState` holds
the :class:`~repro_torch.models.model.Model` itself, whose parameters the
step updates in place (as it does the optimizer's moments), and the step
returns the state with the new optimizer state and step count.  The loss
and its gradients are :func:`~repro_torch.models.model.loss_fn` and
``torch.autograd.grad`` over every parameter (a ``"shared_attn"`` block's
once: the sum over its positions); on the card every attention layer's
gradient is the hand-written ``flash_attention`` backward.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, loss_fn
from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                         adamw_update, cosine_schedule)


class TrainState(NamedTuple):
    model: Model
    opt: AdamWState
    step: int


def train_state_init(model: Model) -> TrainState:
    """Makes every parameter of ``model`` require grad and starts AdamW
    from zero moments at step 0."""
    model.requires_grad_(True)
    return TrainState(model=model, opt=adamw_init(list(model.parameters())),
                      step=0)


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    total_steps: int = 10_000, compute_dtype=torch.float32,
                    attn_impl: str = "auto", dist=None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, float]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``: metrics
    ``loss``, ``ce``, ``aux``, ``grad_norm`` (before clipping) and ``lr``
    (the cosine schedule at the state's step), as the reference names
    them, each a Python float."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        if model.cfg != cfg:
            raise ValueError(f"train_step for {cfg.name} given a model of "
                             f"{model.cfg.name}")
        params = list(model.parameters())
        with torch.enable_grad():
            loss, parts = loss_fn(model, batch, compute_dtype=compute_dtype,
                                  attn_impl=attn_impl, dist=dist)
            grads = torch.autograd.grad(loss, params,
                                        materialize_grads=True)
        lr = cosine_schedule(state.step, peak_lr=peak_lr, total=total_steps)
        _, opt, gnorm = adamw_update(grads, state.opt, params, lr=lr)
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                   "grad_norm": gnorm}
        metrics = {k: float(v.detach()) for k, v in metrics.items()}
        metrics["lr"] = lr
        return TrainState(model, opt, state.step + 1), metrics

    return train_step
