"""Public op: GQA prefill / encoder attention (the flash-attention kernel).

``flash_attention`` takes the model's layout, q (B, Sq, H, D) and k / v
(B, Skv, KH, D), as ``repro.kernels.flash_attention.ops.flash_attention``
does.  For CUDA tensors it launches the hand-written CUDA kernel
(``csrc/flash_attention.cu``), which reads the tensors in place through
their strides (no transpose copy); for CPU tensors it takes the plain
version (``ref.py``).  A CUDA tensor never reaches the plain version: a
kernel that fails to build or launch raises.  The op takes what the kernel
builds, on either device: head dims 64, 80, 128 and 256, f32 or bf16, H %
KH == 0, any Sq, Skv >= 1.  ``flash_attention.launches`` counts kernel
launches, ``flash_attention.launches_by_mask`` the same split into causal
and non-causal, and ``flash_attention.launches_windowed`` those with a
window > 0.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._attention import (DTYPES, F, I, L, P,
                                            check_operands, check_strides,
                                            raise_on_error)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "HEAD_DIMS"]

HEAD_DIMS = (64, 80, 128, 256)  # the head dims the kernel is built for


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention.argtypes = ([I, P, P, P, P] + [L] * 9 + [I] * 8
                                    + [F, P])
    lib.flash_attention.restype = I
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, Sq, H, D) and k, v "
                         f"(B, Skv, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    (b, sq, h, d), (bk, skv, kh, dk) = q.shape, k.shape
    if bk != b or dk != d or h % kh or sq < 1 or skv < 1:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f" (need the same B and D, H % KH == 0, S >= 1)")
    check_operands("flash_attention", q, k, v, window, HEAD_DIMS)


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    check_strides("flash_attention", q, k, v)
    (b, sq, h, d), skv, kh = q.shape, k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], b, sq, skv, h, kh, d, int(causal), window,
            d ** -0.5, stream)
    raise_on_error("flash_attention", err)
    flash_attention.launches += 1
    flash_attention.launches_by_mask[
        "causal" if causal else "non_causal"] += 1
    flash_attention.launches_windowed += int(window > 0)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KH, D) -> (B, Sq, H, D) in q's dtype.

    Positions count from 0 for q and for k: ``causal`` keeps k <= q and a
    ``window`` > 0 keeps k > q - window."""
    _check(q, k, v, window)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    if q.device.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window)
        return out.transpose(1, 2)
    raise ValueError(f"unsupported device {q.device}")


flash_attention.launches = 0
flash_attention.launches_by_mask = {"causal": 0, "non_causal": 0}
flash_attention.launches_windowed = 0
