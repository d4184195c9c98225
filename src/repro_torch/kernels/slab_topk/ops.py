"""Public op: ragged multi-query top-k over a packed cluster slab.

``slab_topk`` launches the hand-written CUDA kernel of the slab's mode
(``csrc/slab_topk.cu``) for CUDA tensors and takes the plain version
(``ref.py``) only for CPU tensors; a kernel that fails to build or launch
raises.  The mode follows the slab's dtype and the keyword operands:

  fp32  emb float32
  fp16  emb float16
  int8  emb int8 with ``scales`` (N, 1) float32
  pq    emb (N, m) uint8 codes with ``luts`` (Q, m, 256) float32

Every mode is one launch a call (``csrc/topk_tiled.cuh``), with the merge
inside, and takes any D or m: rows, queries and tables cross shared memory
a slice at a time.  The slab goes to the kernel in its compact dtype:
nothing here widens it.  ``slab_topk.launches`` counts kernel calls,
``slab_topk.launches_by_mode`` the same per mode.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, _tiled
from repro_torch.kernels.slab_topk.ref import NOT_PROBED, slab_topk_ref

__all__ = ["slab_topk", "slab_mode", "NOT_PROBED", "ROW_PAD", "MODES"]

ROW_PAD = 2**30    # row index of a padded output lane (k > N)
MODES = ("fp32", "fp16", "int8", "pq")
_SLAB_DTYPE = {"fp32": torch.float32, "fp16": torch.float16,
               "int8": torch.int8, "pq": torch.uint8}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    """(library with its signatures set, scratch bytes of (n, nq, k)),
    once."""
    lib = _build.load("slab_topk")
    for mode in MODES:
        fn = getattr(lib, f"slab_topk_{mode}")
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                       ctypes.c_longlong, _P, _P, _P]
        fn.restype = _I
    lib.slab_topk_scratch_bytes.argtypes = [_I, _I, _I]
    lib.slab_topk_scratch_bytes.restype = ctypes.c_size_t
    return lib, functools.lru_cache(maxsize=1024)(
        lib.slab_topk_scratch_bytes)


def slab_mode(emb: torch.Tensor, queries: torch.Tensor, virt: torch.Tensor,
              scales: Optional[torch.Tensor] = None,
              luts: Optional[torch.Tensor] = None) -> str:
    """The slab's mode, after checking every operand's dtype, shape and
    device; raises on anything malformed."""
    mode = next((m for m, dt in _SLAB_DTYPE.items() if emb.dtype == dt), None)
    if mode is None:
        raise TypeError(f"slab_topk takes float32, float16, int8 or uint8 "
                        f"(pq codes) slabs, got {emb.dtype}")
    if queries.dtype != torch.float32:
        raise TypeError(f"queries must be float32, got {queries.dtype}")
    if virt.dtype != torch.int32:
        raise TypeError(f"virt must be int32, got {virt.dtype}")
    if (scales is not None) != (mode == "int8"):
        raise ValueError("scales= goes with an int8 slab, and only there")
    if (luts is not None) != (mode == "pq"):
        raise ValueError("luts= goes with a uint8 pq code slab, and only "
                         "there")
    ops = [emb, queries, virt] + [a for a in (scales, luts) if a is not None]
    if len({a.device for a in ops}) != 1:
        raise ValueError("every slab_topk operand must be on one device")
    n, nq = emb.shape[0], queries.shape[0]
    if (emb.dim() != 2 or queries.dim() != 2 or virt.shape != (nq, n)
            or (mode != "pq" and emb.shape[1] != queries.shape[1])):
        raise ValueError(f"bad shapes emb {tuple(emb.shape)}, queries "
                         f"{tuple(queries.shape)}, virt {tuple(virt.shape)}")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.shape != (n, 1)):
        raise ValueError(f"scales must be float32 ({n}, 1), got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if luts is not None and (luts.dtype != torch.float32
                             or luts.shape != (nq, emb.shape[1], 256)):
        raise ValueError(f"luts must be float32 ({nq}, {emb.shape[1]}, 256),"
                         f" got {luts.dtype} {tuple(luts.shape)}")
    return mode


def _launch(mode: str, emb: torch.Tensor, queries: torch.Tensor,
            virt: torch.Tensor, k: int, scales: Optional[torch.Tensor],
            luts: Optional[torch.Tensor]):
    lib, scratch_bytes = _lib()
    fn = getattr(lib, f"slab_topk_{mode}")
    qop = luts if mode == "pq" else queries   # the queries, or the tables
    out = _tiled.launch(fn, scratch_bytes, (emb, qop, scales, virt),
                        emb.shape[0], emb.shape[1], queries.shape[0], k)
    slab_topk.launches += 1
    slab_topk.launches_by_mode[mode] += 1
    return out


def slab_topk(emb: torch.Tensor, queries: torch.Tensor, virt: torch.Tensor,
              k: int, *, scales: Optional[torch.Tensor] = None,
              luts: Optional[torch.Tensor] = None):
    """emb (N, D) f32 / f16 / int8 (+ ``scales`` (N, 1) f32) or (N, m)
    uint8 PQ codes (+ ``luts`` (Q, m, 256) f32), queries (Q, D) f32, virt
    (Q, N) int32, all on one device -> (vals (Q, k) f32, rows (Q, k)
    int32): per query the best k member rows (``virt < NOT_PROBED``) by
    (score desc, virt asc).

    PADDING: lanes past a query's member count are NOT self-describing --
    they carry NEG_INF (-1e30) scores and in-range non-member rows
    (``ROW_PAD`` appears only in the k > N overflow lanes).  Callers MUST
    mask by the per-query member count (``SlabLayout.query_layout``'s
    ``n_valid_seg``) before gathering ids.
    """
    mode = slab_mode(emb, queries, virt, scales, luts)
    n, nq = emb.shape[0], queries.shape[0]
    dev = emb.device
    if n == 0 or k == 0 or nq == 0:
        return (torch.full((nq, k), float("-inf"), device=dev),
                torch.full((nq, k), ROW_PAD, dtype=torch.int32, device=dev))
    k_eff = min(k, n)
    if dev.type == "cuda":
        vals, rows = _launch(mode, emb, queries, virt, k_eff, scales, luts)
    elif dev.type == "cpu":
        vals, rows = slab_topk_ref(emb, queries, virt, k_eff, scales=scales,
                                   luts=luts)
    else:
        raise ValueError(f"unsupported device {dev}")
    if k_eff < k:
        pad = k - k_eff
        vals = torch.cat([vals, vals.new_full((nq, pad), float("-inf"))], 1)
        rows = torch.cat([rows, rows.new_full((nq, pad), ROW_PAD)], 1)
    return vals, rows


slab_topk.launches = 0
slab_topk.launches_by_mode = dict.fromkeys(MODES, 0)
