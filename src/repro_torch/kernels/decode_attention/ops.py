"""Public ops: one-token decode attention against a KV cache, with per-slot
lengths, over an f32 / bf16 cache (``decode_attention``) or an int8 cache
with per-(token, kv head) f32 scales (``decode_attention_q8``, the cache
of ``models.quantization``).

``decode_attention`` takes q (B, 1, H, D), a cache (B, Smax, KH, D) and the
lengths (an int for every slot, a (B,) integer tensor, or a
:class:`DecodeLengths`), with the semantics of the model's
``attend_decode``: position j of slot b is valid when j < lengths[b] and,
with a window > 0, j > lengths[b] - 1 - window (over a ring cache the model
passes no window: its length reaches Smax once the ring is full, and then
every row is valid).
For CUDA tensors it launches the hand-written CUDA kernel
(``csrc/decode_attention.cu``), which reads q and the cache in place
through their strides; for CPU tensors it takes the plain version
(``ref.py``).  A CUDA tensor never reaches the plain version: a kernel that
fails to build or launch raises.  The op takes what the kernel builds, on
either device: head dims 32, 64, 80, 128 and 256, f32 or bf16, H % KH ==
0, and every length >= 1 (at 0 the JAX package's Pallas kernel and its
reference disagree, and the model never asks for it).

``decode_attention_q8`` takes q (B, 1, H, D) f32 or bf16, k_q / v_q int8
(B, Smax, KH, D) and k_scale / v_scale f32 (B, Smax, KH, 1), with the same
lengths, window, GQA and output dtype; its kernel is the same one
(``csrc/decode_attention.cu``), dequantizing each element right after its
load, so it gives ``decode_attention`` on the dequantized cache.

Either is one launch a call: the kernel splits the cache across blocks and
merges their partials in the same launch, on the zeroed counters and the
scratch buffer that ``kernels/_tiled.py`` keeps per (card, stream).

An int length goes to the kernel as an argument.  A tensor of lengths is
checked where it lies: on the card that waits for the device, once per
call.  :func:`decode_lengths` makes that check once and returns a
:class:`DecodeLengths` (the (B,) int32 tensor on the card) that every
layer of a decode step passes on unchecked.  ``decode_attention.launches``
and ``decode_attention_q8.launches`` count kernel launches, and each
one's ``launches_by_dtype`` its launches by q's dtype (``"float32"`` /
``"bfloat16"``; for K6 also the cache's).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Union

import torch

from repro_torch.kernels import _build, _tiled
from repro_torch.kernels._attention import (DTYPES, F, I, L, P,
                                            check_operands, check_strides,
                                            dtype_name, raise_on_error)
from repro_torch.kernels.decode_attention.ref import (decode_attention_q8_ref,
                                                      decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_q8", "decode_lengths",
           "DecodeLengths", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 80, 128, 256)  # the head dims the kernel is built for


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
    tail = [F, P, L, P, L, P]   # scale, tickets, scratch, stream
    lib.decode_attention.argtypes = ([I, P, P, P, P] + [L] * 8 + [P]
                                     + [I] * 7 + tail)
    lib.decode_attention.restype = I
    lib.decode_attention_q8.argtypes = ([I] + [P] * 6 + [L] * 14 + [P]
                                        + [I] * 7 + tail)
    lib.decode_attention_q8.restype = I
    lib.decode_attention_scratch_bytes.argtypes = [I] * 5
    lib.decode_attention_scratch_bytes.restype = L
    return lib


@functools.cache
def _scratch_bytes(b: int, smax: int, h: int, kh: int, d: int) -> int:
    """Bytes of the partials a launch of these shapes writes."""
    return _lib().decode_attention_scratch_bytes(b, smax, h, kh, d)


def _check(op: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int, cache_dtype=None) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{op} takes q (B, 1, H, D) and a cache "
                         f"(B, Smax, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    (b, _, h, d), (bk, smax, kh, dk) = q.shape, k.shape
    if bk != b or dk != d or h % kh or smax < 1:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)} (need the same B and D, "
                         f"H % KH == 0)")
    check_operands(op, q, k, v, window, HEAD_DIMS, cache_dtype=cache_dtype)


def _check_scales(q: torch.Tensor, k_q: torch.Tensor, k_scale: torch.Tensor,
                  v_scale: torch.Tensor) -> None:
    want = (*k_q.shape[:3], 1)
    if k_scale.shape != want or v_scale.shape != want:
        raise ValueError(f"decode_attention_q8 takes scales {want} for a "
                         f"cache {tuple(k_q.shape)}, got "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"decode_attention_q8 takes float32 scales, got "
                        f"{k_scale.dtype}, {v_scale.dtype}")
    if not q.device == k_scale.device == v_scale.device:
        raise ValueError("decode_attention_q8: q, the cache and its scales "
                         "must be on one device")


def _checked_lengths(q: torch.Tensor,
                     lengths: Union[int, torch.Tensor, DecodeLengths]
                     ) -> Union[int, DecodeLengths]:
    if isinstance(lengths, DecodeLengths):
        if lengths.lengths.shape != (q.shape[0],) or \
                lengths.lengths.device != q.device:
            raise ValueError(f"DecodeLengths of shape "
                             f"{tuple(lengths.lengths.shape)} on "
                             f"{lengths.lengths.device} for q "
                             f"{tuple(q.shape)} on {q.device}")
        return lengths
    return decode_lengths(lengths, q.shape[0], q.device)


def _lens_args(lengths: Union[int, DecodeLengths]) -> tuple:
    """The C interface's (lens pointer or null, len_all)."""
    if isinstance(lengths, DecodeLengths):
        return lengths.lengths.data_ptr(), 0
    return None, lengths


def _launch(op, q: torch.Tensor, cache: tuple,
            lengths: Union[int, DecodeLengths], window: int) -> torch.Tensor:
    """Launches ``op``'s C entry (``decode_attention`` or
    ``decode_attention_q8``) over the ``cache`` tensors, passed in the
    entry's order, each with its (B, S, KH) strides, on the current
    stream's counters and scratch; counts the launch on ``op``, in all and
    by q's dtype."""
    check_strides(op.__name__, q, *cache)
    (b, _, h, d), (smax, kh) = q.shape, cache[0].shape[1:3]
    dev = q.device
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=dev)

    def call():
        stream, tickets, ntickets = _tiled.stream_and_tickets(dev, b * kh)
        scratch, nscratch = _tiled.stream_scratch(
            dev, stream, _scratch_bytes(b, smax, h, kh, d))
        return getattr(_lib(), op.__name__)(
            DTYPES[q.dtype], q.data_ptr(), *(t.data_ptr() for t in cache),
            out.data_ptr(), q.stride(0), q.stride(2),
            *(s for t in cache for s in t.stride()[:3]),
            *_lens_args(lengths), b, smax, h, kh, d, window, d ** -0.5,
            tickets, ntickets, scratch, nscratch, stream)

    raise_on_error(op.__name__, _tiled.on_card(dev, call))
    op.launches += 1
    op.launches_by_dtype[dtype_name(q.dtype)] += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: Union[int, torch.Tensor, DecodeLengths], *,
                     window: int = 0) -> torch.Tensor:
    """q (B, 1, H, D); cache (B, Smax, KH, D); lengths an int, (B,) or a
    :class:`DecodeLengths` -> (B, 1, H, D) in q's dtype."""
    _check("decode_attention", q, k_cache, v_cache, window)
    lengths = _checked_lengths(q, lengths)
    if q.device.type == "cuda":
        return _launch(decode_attention, q, (k_cache, v_cache), lengths,
                       window)
    if q.device.type == "cpu":
        if isinstance(lengths, DecodeLengths):
            lengths = lengths.lengths
        return decode_attention_ref(q[:, 0], k_cache, v_cache, lengths,
                                    window=window)[:, None]
    raise ValueError(f"unsupported device {q.device}")


decode_attention.launches = 0
decode_attention.launches_by_dtype = {"float32": 0, "bfloat16": 0}


def decode_attention_q8(q: torch.Tensor, k_q: torch.Tensor,
                        k_scale: torch.Tensor, v_q: torch.Tensor,
                        v_scale: torch.Tensor,
                        lengths: Union[int, torch.Tensor, DecodeLengths], *,
                        window: int = 0) -> torch.Tensor:
    """q (B, 1, H, D); int8 cache (B, Smax, KH, D) with f32 scales (B,
    Smax, KH, 1); lengths an int, (B,) or a :class:`DecodeLengths` -> (B,
    1, H, D) in q's dtype."""
    _check("decode_attention_q8", q, k_q, v_q, window,
           cache_dtype=torch.int8)
    _check_scales(q, k_q, k_scale, v_scale)
    lengths = _checked_lengths(q, lengths)
    if q.device.type == "cuda":
        return _launch(decode_attention_q8, q, (k_q, k_scale, v_q, v_scale),
                       lengths, window)
    if q.device.type == "cpu":
        if isinstance(lengths, DecodeLengths):
            lengths = lengths.lengths
        return decode_attention_q8_ref(q[:, 0], k_q, k_scale, v_q, v_scale,
                                       lengths, window=window)[:, None]
    raise ValueError(f"unsupported device {q.device}")


decode_attention_q8.launches = 0
decode_attention_q8.launches_by_dtype = {"float32": 0, "bfloat16": 0}
