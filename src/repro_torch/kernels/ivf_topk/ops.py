"""Public op: top-k inner-product search (the centroid probe).

``topk_ip`` launches the hand-written CUDA kernel (``csrc/ivf_topk.cu``, one
launch a call) for CUDA tensors and takes the plain version (``ref.py``)
only for CPU tensors.  A CUDA tensor never reaches the plain version: a
kernel that fails to build or launch raises.  ``topk_ip.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _tiled
from repro_torch.kernels.ivf_topk.ref import topk_ip_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    """(library with its signatures set, scratch bytes of (n, nq, k)),
    once."""
    lib = _build.load("ivf_topk")
    lib.ivf_topk.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P,
                             ctypes.c_longlong, _P, _P, _P]
    lib.ivf_topk.restype = _I
    lib.ivf_topk_scratch_bytes.argtypes = [_I, _I, _I]
    lib.ivf_topk_scratch_bytes.restype = ctypes.c_size_t
    return lib, functools.lru_cache(maxsize=1024)(lib.ivf_topk_scratch_bytes)


def _launch(embs: torch.Tensor, queries: torch.Tensor, k: int):
    if embs.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("ivf_topk kernel takes float32 embs and queries")
    lib, scratch_bytes = _lib()
    (n, d), nq = embs.shape, queries.shape[0]
    out = _tiled.launch(lib.ivf_topk, scratch_bytes, (embs, queries), n, d,
                        nq, k)
    topk_ip.launches += 1
    return out


def topk_ip(embs: torch.Tensor, queries: torch.Tensor, k: int):
    """embs (N, D), queries (Q, D) on one device -> (scores (Q, k) f32,
    idx (Q, k) int32), best first, ties to the lower index.  Lanes past N
    (k > N) carry ``-inf`` and ``-1``."""
    if embs.device != queries.device:
        raise ValueError(f"embs on {embs.device}, queries on {queries.device}")
    if embs.dim() != 2 or queries.dim() != 2 or embs.shape[1] != queries.shape[1]:
        raise ValueError(f"bad shapes {tuple(embs.shape)}, {tuple(queries.shape)}")
    n, nq = embs.shape[0], queries.shape[0]
    k_eff = min(k, n)
    dev = embs.device
    if k_eff == 0 or nq == 0:
        vals = torch.empty((nq, 0), dtype=torch.float32, device=dev)
        idx = torch.empty((nq, 0), dtype=torch.int32, device=dev)
    elif dev.type == "cuda":
        vals, idx = _launch(embs, queries, k_eff)
    elif dev.type == "cpu":
        vals, idx = topk_ip_ref(embs, queries, k_eff)
    else:
        raise ValueError(f"unsupported device {dev}")
    if k_eff < k:
        pad = k - k_eff
        vals = torch.cat([vals, vals.new_full((nq, pad), float("-inf"))], 1)
        idx = torch.cat([idx, idx.new_full((nq, pad), -1)], 1)
    return vals, idx


topk_ip.launches = 0
