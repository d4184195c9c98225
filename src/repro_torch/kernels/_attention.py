"""Checks and C types shared by the attention wrappers (``flash_attention``
and ``decode_attention``): what both CUDA kernels build, and the operand
rules both wrappers hold on either device.
"""
from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (64, 80, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C interface's codes

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def check_operands(op: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, window: int) -> None:
    """Raises unless q, k, v have a built head dim, one dtype the kernels
    take, one device, and ``window >= 0``."""
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{op} kernel is built for head dims {HEAD_DIMS}, "
                         f"not {d}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{op} takes float32 or bfloat16 operands of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"{op}: q, k and v must be on one device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def check_strides(op: str, *tensors: torch.Tensor) -> None:
    """The kernels read the head dim contiguously."""
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{op} kernel reads the head dim contiguously "
                         f"(stride 1)")


def raise_on_error(op: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: cudaError {err}")
