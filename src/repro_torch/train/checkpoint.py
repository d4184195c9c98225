"""Checkpointing: a model's parameters <-> ``.npz`` with path-keyed entries.

Port of ``repro.train.checkpoint``.  The file is the JAX package's for the
same config: one entry per leaf of the JAX params tree
(:func:`repro_torch.convert.params_to_jax`), keyed by its path as
``_path_str`` joins it (``embed``, ``blocks/0/wq``, ``blocks/0/mlp/gate``,
``shared/wq`` for a ``"shared_attn"`` block, ...; dict keys sorted, tuple
entries in order), each pattern position's leaves stacked over depth, no
entry for a ``None`` leaf.  So each package loads the other's file.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np

from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models.model import Model


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in ``jax.tree_util``'s order: dict keys sorted, tuple
    entries by index, ``None`` holding no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from _flatten(sub, f"{prefix}/{key}" if prefix else key)


def _unflatten(tree: Any, leaves: Dict[str, np.ndarray], prefix: str = ""):
    """``tree`` with each leaf replaced by ``leaves[its path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves,
                                     f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return leaves[prefix]


def save_checkpoint(path: str, model: Model) -> None:
    """Writes ``model``'s parameters to ``path`` (``np.savez``: ``.npz`` is
    added if missing), creating its directory."""
    arrays = dict(_flatten(params_to_jax(model)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path: str, like: Model) -> Model:
    """A new :class:`Model` of ``like``'s config, on ``like``'s device and
    in its dtype, holding the parameters in ``path``; raises if an entry is
    missing or its shape is not ``like``'s."""
    template = params_to_jax(like)
    leaves = {}
    with np.load(path) as data:
        for key, v in _flatten(template):
            if key not in data:
                raise KeyError(f"{path}: no entry {key!r}")
            arr = data[key]
            if arr.shape != v.shape:
                raise ValueError(f"{path}: {key} has shape {arr.shape}, "
                                 f"the model's is {v.shape}")
            leaves[key] = arr.astype(v.dtype)
    return params_from_jax(_unflatten(template, leaves), like.cfg,
                           device=like.device, dtype=like.embed.dtype)
