"""Public op: one-token decode attention against a KV cache, with per-slot
lengths.

``decode_attention`` takes q (B, 1, H, D), a cache (B, Smax, KH, D) and the
lengths (an int for every slot, a (B,) integer tensor, or a
:class:`DecodeLengths`), with the semantics of the model's
``attend_decode`` on a full (non-ring) cache: position j of slot b is valid
when j < lengths[b] and, with a window > 0, j > lengths[b] - 1 - window.
For CUDA tensors it launches the hand-written CUDA kernel
(``csrc/decode_attention.cu``), which reads q and the cache in place
through their strides; for CPU tensors it takes the plain version
(``ref.py``).  A CUDA tensor never reaches the plain version: a kernel that
fails to build or launch raises.  The op takes what the kernel builds, on
either device: head dims 64, 80 and 128, f32 or bf16, H % KH == 0, and
every length >= 1 (at 0 the JAX package's Pallas kernel and its reference
disagree, and the model never asks for it).

An int length goes to the kernel as an argument.  A tensor of lengths is
checked where it lies: on the card that waits for the device, once per
call.  :func:`decode_lengths` makes that check once and returns a
:class:`DecodeLengths` (the (B,) int32 tensor on the card) that every
layer of a decode step passes on unchecked.  ``decode_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._attention import (DTYPES, F, I, L, P,
                                            check_operands, check_strides,
                                            raise_on_error)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_lengths", "DecodeLengths"]


@dataclasses.dataclass(frozen=True)
class DecodeLengths:
    """Per-slot lengths that :func:`decode_lengths` found all >= 1, as a
    contiguous (B,) int32 tensor on their device."""
    lengths: torch.Tensor


def decode_lengths(lengths: Union[int, torch.Tensor], batch: int,
                   device: torch.device) -> Union[int, DecodeLengths]:
    """Checks ``lengths`` (an int, or a (batch,) integer tensor anywhere)
    once: raises for a length under 1; returns the int, or the lengths as a
    :class:`DecodeLengths` on ``device``.  A tensor is checked where it
    lies, before the copy (on the card, the check waits for it)."""
    if isinstance(lengths, DecodeLengths):
        lengths = lengths.lengths
    if isinstance(lengths, torch.Tensor):
        if lengths.dim() != 1 or lengths.shape[0] != batch or \
                lengths.dtype.is_floating_point:
            raise ValueError(f"lengths must be an int or a ({batch},) "
                             f"integer tensor, got {lengths.dtype} "
                             f"{tuple(lengths.shape)}")
        if bool((lengths < 1).any()):
            raise ValueError("decode_attention needs every length >= 1 (the "
                             "current token is in the cache)")
        return DecodeLengths(lengths.to(device=device, dtype=torch.int32)
                             .contiguous())
    lengths = int(lengths)
    if lengths < 1:
        raise ValueError("decode_attention needs every length >= 1 (the "
                         "current token is in the cache)")
    return lengths


@functools.cache
def _lib():
    lib = _build.load("decode_attention")
    lib.decode_attention.argtypes = ([I, P, P, P, P] + [L] * 8 + [P]
                                     + [I] * 7 + [F, P])
    lib.decode_attention.restype = I
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention takes q (B, 1, H, D) and a cache "
                         f"(B, Smax, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    (b, _, h, d), (bk, smax, kh, dk) = q.shape, k.shape
    if bk != b or dk != d or h % kh or smax < 1:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)} (need the same B and D, "
                         f"H % KH == 0)")
    check_operands("decode_attention", q, k, v, window)


def _launch(q, k, v, lengths: Union[int, DecodeLengths],
            window: int) -> torch.Tensor:
    check_strides("decode_attention", q, k, v)
    (b, _, h, d), smax, kh = q.shape, k.shape[1], k.shape[2]
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    per_slot = isinstance(lengths, DecodeLengths)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().decode_attention(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), q.stride(0), q.stride(2), *k.stride()[:3],
            *v.stride()[:3], lengths.lengths.data_ptr() if per_slot else None,
            0 if per_slot else lengths, b, smax, h, kh, d, window,
            d ** -0.5, stream)
    raise_on_error("decode_attention", err)
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: Union[int, torch.Tensor, DecodeLengths], *,
                     window: int = 0) -> torch.Tensor:
    """q (B, 1, H, D); cache (B, Smax, KH, D); lengths an int, (B,) or a
    :class:`DecodeLengths` -> (B, 1, H, D) in q's dtype."""
    _check(q, k_cache, v_cache, window)
    if isinstance(lengths, DecodeLengths):
        if lengths.lengths.shape != (q.shape[0],) or \
                lengths.lengths.device != q.device:
            raise ValueError(f"DecodeLengths of shape "
                             f"{tuple(lengths.lengths.shape)} on "
                             f"{lengths.lengths.device} for q "
                             f"{tuple(q.shape)} on {q.device}")
    else:
        lengths = decode_lengths(lengths, q.shape[0], q.device)
    if q.device.type == "cuda":
        return _launch(q, k_cache, v_cache, lengths, window)
    if q.device.type == "cpu":
        if isinstance(lengths, DecodeLengths):
            lengths = lengths.lengths
        return decode_attention_ref(q[:, 0], k_cache, v_cache, lengths,
                                    window=window)[:, None]
    raise ValueError(f"unsupported device {q.device}")


decode_attention.launches = 0
