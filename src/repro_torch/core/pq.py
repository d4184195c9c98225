"""Product quantization: per-subspace codebooks for the compact storage tier.

Port of ``repro.core.pq``.  A :class:`PQCodebook` splits the embedding
dimension into ``m`` subspaces, trains 256 Euclidean k-means centroids per
subspace (:func:`repro_torch.core.kmeans.kmeans_euclidean`, Lloyd steps on
the caller's device), and represents each row as ``m`` uint8 codes — one
byte per subspace.

``pq_encode``, ``pq_decode`` and ``pq_luts`` are plain numpy, as in the JAX
package, so on one codebook both packages give bitwise the same codes,
reconstructions and tables (a re-implementation in torch could flip the
encoder's argmin on near-ties).

Scoring is asymmetric (ADC): the query stays full-precision, and per-query
lookup tables ``luts[q, j, c] = <query_q[sub_j], codebook[j, c]>`` reduce a
row's inner-product score to ``m`` table lookups + adds (the ``"pq"`` mode
of ``slab_topk``).  LUT construction is charged by
``EdgeCostModel.pq_lut_latency``; the gather+accumulate by
``pq_gather_latency``.

Dims not divisible by ``m`` are zero-padded up to ``m·dsub``: padding
coordinates contribute exact zeros to both reconstruction and inner products.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.kmeans import kmeans_euclidean
from repro_torch.device import DeviceLike

KSUB = 256           # centroids per subspace -> one uint8 code per subspace


@dataclasses.dataclass(frozen=True)
class PQCodebook:
    """Trained product quantizer: ``codebooks[j]`` holds the 256 centroids of
    subspace ``j``.  ``version`` stamps every encoded payload (member
    ``cbv``) so stale codes from a pre-retrain era are detected at read
    time."""
    codebooks: np.ndarray        # (m, KSUB, dsub) float32
    dim: int                     # original embedding dim (pre-padding)
    version: int = 0

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def nbytes(self) -> int:
        return int(self.codebooks.nbytes)


def _split(x: np.ndarray, m: int, dsub: int) -> np.ndarray:
    """(n, dim) -> (n, m, dsub), zero-padding the tail subspace."""
    n, dim = x.shape
    pad = m * dsub - dim
    if pad:
        x = np.concatenate(
            [x, np.zeros((n, pad), np.float32)], axis=1)
    return x.reshape(n, m, dsub)


def train_pq(x: np.ndarray, m: int = 8, iters: int = 12, seed: int = 0,
             version: int = 0, *, device: DeviceLike = None) -> PQCodebook:
    """Train ``m`` per-subspace codebooks of :data:`KSUB` centroids each,
    the Lloyd steps on ``device`` (the card unless ``"cpu"``).

    ``dsub = ceil(dim / m)``; with fewer than KSUB training rows each
    subspace simply gets ``n`` centroids padded (by repetition of the
    first) up to KSUB so code values are always valid indices."""
    x = np.ascontiguousarray(x, np.float32)
    n, dim = x.shape
    if n == 0:
        raise ValueError("cannot train a PQ codebook on 0 rows")
    m = min(m, dim)
    dsub = -(-dim // m)                                 # ceil division
    sub = _split(x, m, dsub)                            # (n, m, dsub)
    books = np.zeros((m, KSUB, dsub), np.float32)
    for j in range(m):
        cent, _ = kmeans_euclidean(sub[:, j, :], KSUB, iters=iters,
                                   seed=seed + j, device=device)
        books[j, :len(cent)] = cent
        if len(cent) < KSUB:                            # n < KSUB rows
            books[j, len(cent):] = cent[0]
    return PQCodebook(codebooks=books, dim=dim, version=version)


def pq_encode(cb: PQCodebook, x: np.ndarray) -> np.ndarray:
    """(n, dim) float -> (n, m) uint8 nearest-centroid codes."""
    x = np.ascontiguousarray(x, np.float32)
    if x.shape[1] != cb.dim:
        raise ValueError(f"dim mismatch: {x.shape[1]} != {cb.dim}")
    sub = _split(x, cb.m, cb.dsub)                      # (n, m, dsub)
    codes = np.empty((x.shape[0], cb.m), np.uint8)
    for j in range(cb.m):
        b = cb.codebooks[j]                             # (KSUB, dsub)
        # ||s - b||^2 = ||s||^2 - 2 s·b + ||b||^2 ; drop the row term
        d = np.sum(b * b, axis=1)[None, :] - 2.0 * (sub[:, j, :] @ b.T)
        codes[:, j] = np.argmin(d, axis=1)
    return codes


def pq_decode(cb: PQCodebook, codes: np.ndarray) -> np.ndarray:
    """(n, m) uint8 -> (n, dim) float32 centroid reconstruction."""
    codes = np.asarray(codes)
    n = codes.shape[0]
    out = np.empty((n, cb.m * cb.dsub), np.float32)
    for j in range(cb.m):
        out[:, j * cb.dsub:(j + 1) * cb.dsub] = cb.codebooks[j][codes[:, j]]
    return out[:, :cb.dim]


def pq_luts(cb: PQCodebook, queries: np.ndarray) -> np.ndarray:
    """Per-query ADC tables: (Q, dim) -> (Q, m, KSUB) float32 with
    ``luts[q, j, c] = <queries[q][sub_j], codebooks[j, c]>`` so a row's
    asymmetric inner-product score is ``sum_j luts[q, j, codes[r, j]]``."""
    queries = np.ascontiguousarray(queries, np.float32)
    if queries.shape[1] != cb.dim:
        raise ValueError(f"dim mismatch: {queries.shape[1]} != {cb.dim}")
    qsub = _split(queries, cb.m, cb.dsub)               # (Q, m, dsub)
    # einsum over the shared subspace axis: (Q, m, dsub) x (m, KSUB, dsub)
    return np.einsum("qjd,jkd->qjk", qsub, cb.codebooks,
                     optimize=True).astype(np.float32)


def quantization_error(cb: PQCodebook, x: np.ndarray) -> np.ndarray:
    """Per-row squared reconstruction error ``||x - decode(encode(x))||^2``."""
    rec = pq_decode(cb, pq_encode(cb, x))
    return np.sum((np.asarray(x, np.float32) - rec) ** 2, axis=1)


def codebook_to_payload(cb: PQCodebook) -> dict:
    """Serializable dict (npz-friendly) for persisting alongside a root."""
    return {"codebooks": cb.codebooks,
            "dim": np.array([cb.dim], np.int64),
            "version": np.array([cb.version], np.int64)}


def codebook_from_payload(payload: dict) -> PQCodebook:
    return PQCodebook(
        codebooks=np.ascontiguousarray(payload["codebooks"], np.float32),
        dim=int(np.asarray(payload["dim"]).reshape(-1)[0]),
        version=int(np.asarray(payload["version"]).reshape(-1)[0]))


def subspace_split(x: np.ndarray, cb: PQCodebook) -> np.ndarray:
    """(n, dim) -> (n, m, dsub) padded view."""
    return _split(np.ascontiguousarray(x, np.float32), cb.m, cb.dsub)
