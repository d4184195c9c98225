"""Public op: top-k inner-product search (the centroid probe).

``topk_ip`` launches the hand-written CUDA kernel (``csrc/ivf_topk.cu``) for
CUDA tensors and takes the plain version (``ref.py``) only for CPU tensors.
A CUDA tensor never reaches the plain version: a kernel that fails to build
or launch raises.  ``topk_ip.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_topk.ref import topk_ip_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    """(library with its signatures set, rows per scoring block), once."""
    lib = _build.load("ivf_topk")
    lib.ivf_topk.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]
    lib.ivf_topk.restype = _I
    lib.ivf_topk_chunk_rows.restype = _I
    return lib, lib.ivf_topk_chunk_rows()


def _launch(embs: torch.Tensor, queries: torch.Tensor, k: int):
    if embs.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("ivf_topk kernel takes float32 embs and queries")
    lib, chunk_rows = _lib()
    embs, queries = embs.contiguous(), queries.contiguous()
    (n, d), nq = embs.shape, queries.shape[0]
    dev = embs.device
    nchunks = -(-n // chunk_rows)
    part_v = torch.empty((nq, nchunks, k), dtype=torch.float32, device=dev)
    part_t = torch.empty((nq, nchunks, k), dtype=torch.int32, device=dev)
    part_i = torch.empty((nq, nchunks, k), dtype=torch.int32, device=dev)
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ivf_topk(embs.data_ptr(), queries.data_ptr(), n, d, nq, k,
                           part_v.data_ptr(), part_t.data_ptr(),
                           part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                           stream)
    if err != 0:
        raise RuntimeError(f"ivf_topk kernel launch failed: cudaError {err}")
    topk_ip.launches += 1
    return vals, idx


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
