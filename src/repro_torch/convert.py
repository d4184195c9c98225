"""Carry weights and index state from the JAX package into the port.

Both functions take numpy arrays (``jax.tree.map(np.asarray, params)`` on
the JAX side), so the port itself never touches JAX.

* :func:`params_from_jax` — the JAX params pytree holds one stack per
  position of ``cfg.block_pattern``, each leaf stacked over
  ``depth_repeat`` with a leading axis; the port keeps one
  block per layer, layer ``r * len(pattern) + i`` being repeat ``r`` of
  position ``i`` (the JAX layer scan's order), so the converter unstacks
  each parameter from the leaf of its name (a parameter ``a.b`` from
  ``[a][b]``; an :class:`~repro_torch.models.model.AttnBlock`'s SwiGLU
  ``gate`` / ``up`` / ``down`` from ``["mlp"]``).  A ``"shared_attn"``
  position's leaf is ``None``: its one block takes the unstacked
  ``tree["shared"]``, once.  Matrices keep the JAX (in, out) layout on
  both sides.
* :func:`params_to_jax` — the inverse: the model as the JAX params tree
  (numpy leaves), each pattern position's parameters stacked over depth,
  a ``"shared_attn"`` position ``None`` and its one block under
  ``"shared"``; what ``repro.train.checkpoint`` writes and reads.
* :func:`index_state_from_numpy` — loads another index's centroids and
  cluster assignment into a port index (then runs Alg. 1 as ``build``
  does).  Parity tests use it because k-means argmin near-ties make two
  separately trained indexes a bad comparison.
* :func:`ivf_state_from_numpy` — the same for the IVF baseline
  (:class:`~repro_torch.core.ivf_index.IVFIndex`).
* :func:`pq_codebook_from_numpy` — a JAX ``PQCodebook`` (its numpy
  ``codebooks``, ``dim`` and ``version``) as the port's
  :class:`~repro_torch.core.pq.PQCodebook`, for
  ``index_state_from_numpy(..., pq_codebook=)`` (or
  ``StorageBackend.install_pq``) to install; then both packages encode to,
  and score, the same codes.
"""
from __future__ import annotations

from functools import reduce
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pq import PQCodebook
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import AttnBlock, Model


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, *,
                    device: DeviceLike = None, dtype=None) -> Model:
    """A :class:`Model` holding the JAX params ``tree`` (numpy leaves):
    ``{"embed", "blocks": ({"norm1", "wq", "wk", "wv", "wo", "norm2",
    "mlp": {"gate", "up", "down"}}, ...), "final_norm"[, "lm_head"]}``, one
    entry of ``"blocks"`` per pattern position; a ``"moe"`` /
    ``"swa_moe"`` position holds ``"moe": {"router", "gate", "up",
    "down"}`` in place of ``"mlp"``; an ``"rwkv6"`` position holds the
    block's parameters by their names (``norm_t``, ``mu``, ``Wr``, ...,
    ``Wcv``), a ``"mamba2"`` position ``"norm1"`` and ``"mixer": {"in_z",
    ..., "out_proj"}``; a ``"shared_attn"`` position holds ``None`` and
    ``tree["shared"]`` the block, unstacked, as an ``"attn"`` position's
    leaves.

    Leaves of f32 or of bf16 (the ``ml_dtypes`` numpy type that
    ``jax.numpy.bfloat16`` arrays give, as ``init_params(dtype=
    jnp.bfloat16)`` makes them): each is widened through ``np.float32``,
    which is exact, then cast to the model's dtype: ``dtype`` if given,
    else bf16 when the tree's embedding is bf16, else f32."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = (torch.bfloat16 if np.dtype(tree["embed"].dtype).name
                 == "bfloat16" else torch.float32)
    model = Model(cfg, device=dev, dtype=dtype)
    as_t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        device=dev, dtype=dtype)
    with torch.no_grad():
        model.embed.copy_(as_t(tree["embed"]))
        model.final_norm.copy_(as_t(tree["final_norm"]))
        if model.lm_head is not None:
            model.lm_head.copy_(as_t(tree["lm_head"]))
        width = len(cfg.block_pattern)
        for layer, block in enumerate(model.blocks):
            if cfg.block_pattern[layer % width] == "shared_attn":
                if layer >= width:
                    continue             # the one block, copied at layer < width
                src, pick = tree["shared"], lambda a: a
            else:
                src = tree["blocks"][layer % width]
                pick = lambda a, r=layer // width: a[r]
            for name, dst in block.named_parameters():
                path = _block_path(block, name)
                dst.copy_(as_t(pick(reduce(lambda d, k: d[k], path, src))))
    return model


def _block_path(block, name: str) -> List[str]:
    """A parameter's path in the JAX tree's block dict."""
    if isinstance(block, AttnBlock) and block.moe is None \
            and name in ("gate", "up", "down"):
        return ["mlp", name]
    return name.split(".")


def _block_tree(blocks: Sequence, stacked: bool = True) -> Dict[str, Any]:
    """The JAX tree of one pattern position: each parameter of
    ``blocks`` (the position's layers in depth order) stacked over a
    leading axis, or the one shared block's unstacked."""
    tree: Dict[str, Any] = {}
    per = [dict(b.named_parameters()) for b in blocks]
    for name in per[0]:
        arr = np.stack([p[name].detach().cpu().to(torch.float32).numpy()
                        for p in per])
        *head, leaf = _block_path(blocks[0], name)
        reduce(lambda d, k: d.setdefault(k, {}), head, tree)[leaf] = \
            arr if stacked else arr[0]
    return tree


def params_to_jax(model: Model) -> Dict[str, Any]:
    """The JAX params tree of ``model`` (f32 numpy leaves), the layout
    :func:`params_from_jax` reads: ``"blocks"`` a tuple with one entry per
    pattern position, each leaf stacked over ``depth_repeat``; a
    ``"shared_attn"`` position ``None`` and ``"shared"`` its one block,
    unstacked.  A bf16 model's leaves come back widened to f32, which is
    exact (numpy has no bf16 of its own)."""
    cfg = model.cfg
    host = lambda t: t.detach().cpu().to(torch.float32).numpy().copy()
    tree: Dict[str, Any] = {"embed": host(model.embed),
                            "final_norm": host(model.final_norm)}
    if model.lm_head is not None:
        tree["lm_head"] = host(model.lm_head)
    width, blocks = len(cfg.block_pattern), []
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "shared_attn":
            tree["shared"] = _block_tree([model.blocks[i]], stacked=False)
            blocks.append(None)
        else:
            blocks.append(_block_tree([model.blocks[r * width + i] for r in
                                       range(cfg.depth_repeat)]))
    tree["blocks"] = tuple(blocks)
    return tree


def pq_codebook_from_numpy(codebooks: np.ndarray, dim: int,
                           version: int) -> PQCodebook:
    """The port's :class:`PQCodebook` holding ``codebooks`` (m, 256, dsub)
    f32, for embeddings of width ``dim``, stamped ``version``."""
    cb = PQCodebook(codebooks=np.array(codebooks, np.float32),
                    dim=int(dim), version=int(version))
    if cb.codebooks.ndim != 3 or cb.codebooks.shape[1] != 256:
        raise ValueError(f"codebooks must be (m, 256, dsub), got "
                         f"{cb.codebooks.shape}")
    return cb


def index_state_from_numpy(index, centroids: np.ndarray, assign: np.ndarray,
                           chunk_ids: Sequence[int], texts: Sequence[str],
                           embeddings: np.ndarray, *,
                           pq_codebook: Optional[PQCodebook] = None) -> None:
    """Load first-level ``centroids`` (nlist, d) and the per-chunk cluster
    ``assign`` (n,) of another index into the port ``index``; Alg. 1 then
    stores the clusters whose regeneration exceeds the SLO.  Under the pq
    codec the stored clusters are encoded with ``pq_codebook`` (from
    :func:`pq_codebook_from_numpy`, or another port index's
    ``storage.pq``), or with a codebook trained on ``embeddings`` as
    ``build`` does when it is None."""
    index._install(chunk_ids, texts, embeddings, np.asarray(centroids),
                   np.asarray(assign), pq_codebook=pq_codebook)


def ivf_state_from_numpy(index, centroids: np.ndarray, assign: np.ndarray,
                         chunk_ids: Sequence[int],
                         embeddings: np.ndarray) -> None:
    """Load first-level ``centroids`` (nlist, d) and the per-chunk cluster
    ``assign`` (n,) of another index into the port
    :class:`~repro_torch.core.ivf_index.IVFIndex` ``index``: its clusters
    then hold exactly those chunks' ``embeddings`` on its device."""
    index._install(np.asarray(centroids), np.asarray(assign), chunk_ids,
                   embeddings)
