"""Public op: ragged multi-query top-k over a packed fp32 cluster slab.

``slab_topk`` launches the hand-written CUDA kernel (``csrc/slab_topk.cu``)
for CUDA tensors and takes the plain version (``ref.py``) only for CPU
tensors; a kernel that fails to build or launch raises.  fp16 / int8 and PQ
slabs come with the storage-codec slice.  ``slab_topk.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slab_topk.ref import NOT_PROBED, slab_topk_ref

__all__ = ["slab_topk", "NOT_PROBED", "ROW_PAD"]

ROW_PAD = 2**30    # row index of a padded output lane (k > N)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    """(library with its signatures set, rows per scoring block), once."""
    lib = _build.load("slab_topk")
    lib.slab_topk_fp32.argtypes = [_P, _P, _P, _I, _I, _I, _I,
                                   _P, _P, _P, _P, _P, _P]
    lib.slab_topk_fp32.restype = _I
    lib.slab_topk_chunk_rows.restype = _I
    return lib, lib.slab_topk_chunk_rows()


def _launch(emb: torch.Tensor, queries: torch.Tensor, virt: torch.Tensor,
            k: int):
    lib, chunk_rows = _lib()
    emb, queries = emb.contiguous(), queries.contiguous()
    virt = virt.contiguous()
    (n, d), nq = emb.shape, queries.shape[0]
    dev = emb.device
    nchunks = -(-n // chunk_rows)
    part_v = torch.empty((nq, nchunks, k), dtype=torch.float32, device=dev)
    part_t = torch.empty((nq, nchunks, k), dtype=torch.int32, device=dev)
    part_r = torch.empty((nq, nchunks, k), dtype=torch.int32, device=dev)
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    rows = torch.empty((nq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.slab_topk_fp32(
            emb.data_ptr(), queries.data_ptr(), virt.data_ptr(), n, d, nq, k,
            part_v.data_ptr(), part_t.data_ptr(), part_r.data_ptr(),
            vals.data_ptr(), rows.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"slab_topk kernel launch failed: cudaError {err}")
    slab_topk.launches += 1
    return vals, rows


def slab_topk(emb: torch.Tensor, queries: torch.Tensor, virt: torch.Tensor,
              k: int):
    """emb (N, D) f32, queries (Q, D) f32, virt (Q, N) int32, all on one
    device -> (vals (Q, k) f32, rows (Q, k) int32): per query the best k
    member rows (``virt < NOT_PROBED``) by (score desc, virt asc).

    PADDING: lanes past a query's member count are NOT self-describing --
    they carry NEG_INF (-1e30) scores and in-range non-member rows
    (``ROW_PAD`` appears only in the k > N overflow lanes).  Callers MUST
    mask by the per-query member count (``SlabLayout.query_layout``'s
    ``n_valid_seg``) before gathering ids.
    """
    if not (emb.device == queries.device == virt.device):
        raise ValueError("emb, queries and virt must share one device")
    if emb.dtype != torch.float32 or queries.dtype != torch.float32:
        raise NotImplementedError(
            f"slab_topk takes float32 slabs and queries (got {emb.dtype}, "
            f"{queries.dtype}); fp16/int8/pq slabs come with the "
            f"storage-codec slice")
    if virt.dtype != torch.int32:
        raise TypeError(f"virt must be int32, got {virt.dtype}")
    n, nq = emb.shape[0], queries.shape[0]
    if virt.shape != (nq, n) or emb.dim() != 2 or queries.dim() != 2 \
            or emb.shape[1] != queries.shape[1]:
        raise ValueError(f"bad shapes emb {tuple(emb.shape)}, queries "
                         f"{tuple(queries.shape)}, virt {tuple(virt.shape)}")
    dev = emb.device
    if n == 0 or k == 0 or nq == 0:
        return (torch.full((nq, k), float("-inf"), device=dev),
                torch.full((nq, k), ROW_PAD, dtype=torch.int32, device=dev))
    k_eff = min(k, n)
    if dev.type == "cuda":
        vals, rows = _launch(emb, queries, virt, k_eff)
    elif dev.type == "cpu":
        vals, rows = slab_topk_ref(emb, queries, virt, k_eff)
    else:
        raise ValueError(f"unsupported device {dev}")
    if k_eff < k:
        pad = k - k_eff
        vals = torch.cat([vals, vals.new_full((nq, pad), float("-inf"))], 1)
        rows = torch.cat([rows, rows.new_full((nq, pad), ROW_PAD)], 1)
    return vals, rows


slab_topk.launches = 0
