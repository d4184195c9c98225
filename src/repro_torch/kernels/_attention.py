"""Checks and C types shared by the attention wrappers (``flash_attention``,
``decode_attention`` and ``decode_attention_q8``): the operand rules every
wrapper holds on either device, each against the head dims its kernel
builds.
"""
from __future__ import annotations

import ctypes

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C interface's codes


def dtype_name(dtype: torch.dtype) -> str:
    """The key of a wrapper's ``launches_by_dtype``: ``"float32"`` or
    ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def check_operands(op: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, window: int, head_dims: tuple, *,
                   cache_dtype=None) -> None:
    """Raises unless q, k, v have a head dim in ``head_dims``, q a dtype
    the kernels take and k, v the same one (or ``cache_dtype``), one
    device, and ``window >= 0``."""
    d = q.shape[-1]
    if d not in head_dims:
        raise ValueError(f"{op} kernel is built for head dims {head_dims}, "
                         f"not {d}")
    kv_dtype = q.dtype if cache_dtype is None else cache_dtype
    if q.dtype not in DTYPES or k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"{op} takes a float32 or bfloat16 q and k, v of "
                        f"{'its dtype' if cache_dtype is None else kv_dtype}"
                        f", got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"{op}: q, k and v must be on one device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def check_strides(op: str, *tensors: torch.Tensor) -> None:
    """The kernels read the head dim contiguously (a last dim of 1, as a
    scale's, has no stride to speak of)."""
    if any(t.stride(-1) != 1 and t.shape[-1] > 1 for t in tensors):
        raise ValueError(f"{op} kernel reads the head dim contiguously "
                         f"(stride 1)")


def raise_on_error(op: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: cudaError {err}")
