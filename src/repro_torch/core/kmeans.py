"""K-means: spherical for the IVF first level, Euclidean for PQ codebooks.

Port of ``repro.core.kmeans``: k-means++ seeding on the host in numpy with
the same ``default_rng(seed)`` draws as the JAX package, then Lloyd
iterations in torch on the caller's device (plain matmuls).  ``kmeans``
works on unit-normalized embeddings and re-normalizes centroids each
iteration; ``kmeans_euclidean`` keeps unconstrained means (PQ subspaces).
Argmin near-ties can round differently from the JAX package, so parity tests
load a reference index's centroids instead of comparing two trainings.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def kmeans_pp_init(x: np.ndarray, k: int, rng: np.random.Generator):
    """k-means++ seeding (host-side; O(n·k) total)."""
    n = x.shape[0]
    first = int(rng.integers(n))
    centroids = [x[first]]
    d2 = 2.0 - 2.0 * (x @ x[first])                             # unit vectors
    for _ in range(1, k):
        d2c = np.clip(d2, 1e-12, None)
        probs = d2c / d2c.sum()
        idx = int(rng.choice(n, p=probs))
        centroids.append(x[idx])
        d_new = 2.0 - 2.0 * (x @ x[idx])
        d2 = np.minimum(d2, d_new)
    return np.stack(centroids)


def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.argmin(-(x @ c.T), dim=1)      # first index wins a tie


def _update(x: torch.Tensor, assign: torch.Tensor, k: int):
    one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)   # (n, k)
    sums = one_hot.T @ x                                            # (k, d)
    counts = one_hot.sum(0)[:, None]
    cent = sums / torch.clamp(counts, min=1.0)
    norm = torch.linalg.norm(cent, dim=1, keepdim=True)
    return cent / torch.clamp(norm, min=1e-9), counts[:, 0]


def kmeans(x: np.ndarray, k: int, iters: int = 20, seed: int = 0, *,
           device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (centroids (k, d) unit-norm, assignments (n,)) as numpy."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    xn = x / np.clip(norms, 1e-9, None)
    rng = np.random.default_rng(seed)
    k = min(k, x.shape[0])
    cent = kmeans_pp_init(xn, k, rng)
    xt = torch.from_numpy(xn).to(dev)
    ct = torch.from_numpy(cent).to(dev)
    for _ in range(iters):
        ct, counts = _update(xt, _assign(xt, ct), k)
        # re-seed empty clusters to the least-similar points (rare)
        empties = torch.nonzero(counts == 0).flatten()
        if len(empties):
            best = (xt @ ct.T).max(dim=1).values
            far = torch.argsort(best)[:len(empties)]
            ct[empties] = xt[far]
    assign = _assign(xt, ct)
    return ct.cpu().numpy(), assign.cpu().numpy()


def _assign_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    # ||x - c||^2 = ||x||^2 - 2 x·c + ||c||^2 ; the x term is constant per
    # row, so argmin needs only the last two
    return torch.argmin((c * c).sum(1)[None, :] - 2.0 * (x @ c.T), dim=1)


def _update_l2(x: torch.Tensor, assign: torch.Tensor, k: int):
    one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)   # (n, k)
    counts = one_hot.sum(0)[:, None]
    return (one_hot.T @ x) / torch.clamp(counts, min=1.0), counts[:, 0]


def kmeans_euclidean(x: np.ndarray, k: int, iters: int = 20, seed: int = 0,
                     *, device: DeviceLike = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Plain (non-spherical) Lloyd k-means for PQ subspace codebooks:
    centroids are unconstrained means under squared-Euclidean distance.
    Returns (centroids (k, d), assignments (n,)) as numpy."""
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, np.float32)
    rng = np.random.default_rng(seed)
    k = min(k, x.shape[0])
    # k-means++ under true L2 (the unit-vector shortcut does not apply)
    n = x.shape[0]
    cent = [x[int(rng.integers(n))]]
    d2 = np.sum((x - cent[0]) ** 2, axis=1)
    for _ in range(1, k):
        d2c = np.clip(d2, 1e-12, None)
        idx = int(rng.choice(n, p=d2c / d2c.sum()))
        cent.append(x[idx])
        d2 = np.minimum(d2, np.sum((x - x[idx]) ** 2, axis=1))
    xt = torch.from_numpy(x).to(dev)
    ct = torch.from_numpy(np.stack(cent)).to(dev)
    for _ in range(iters):
        assign = _assign_l2(xt, ct)
        ct, counts = _update_l2(xt, assign, k)
        empties = torch.nonzero(counts == 0).flatten()
        if len(empties):
            # re-seed empties to the points farthest from their centroid
            d = ((xt - ct[assign]) ** 2).sum(1)
            far = torch.argsort(-d, stable=True)[:len(empties)]
            ct[empties] = xt[far]
    assign = _assign_l2(xt, ct)
    return ct.cpu().numpy(), assign.cpu().numpy()
