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
and non-causal, ``flash_attention.launches_by_dtype`` by the entry's dtype
(``"float32"`` / ``"bfloat16"``), and ``flash_attention.launches_windowed``
those with a window > 0.

Under grad mode, with an input that requires grad, ``flash_attention``
goes through a ``torch.autograd.Function``: on CUDA tensors the forward
launches the same kernel, asking it for each row's log-sum-exp too, and
the backward launches the hand-written gradient kernel
(``csrc/flash_attention_bwd.cu``, :func:`flash_attention_bwd`); on CPU
tensors the two plain versions.  f32 or bf16: in bf16 the lse is f32 and
the gradients are the f32 gradient of the widened inputs, rounded once to
bf16.  Without grad (serving, ``encode``) the op launches the kernel as
before, with no log-sum-exp.  ``flash_attention_bwd.launches`` counts
gradient calls on the card, ``flash_attention_bwd.launches_by_dtype`` the
same by dtype.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._attention import (DTYPES, F, I, L, P,
                                            check_operands, check_strides,
                                            dtype_name, raise_on_error)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_lse_ref,
                                                     flash_attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "HEAD_DIMS"]

HEAD_DIMS = (64, 80, 128, 256)  # the head dims the kernel is built for


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention.argtypes = ([I, P, P, P, P] + [L] * 9 + [I] * 8
                                    + [F, P, P])
    lib.flash_attention.restype = I
    return lib


@functools.cache
def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd.argtypes = [I] + [P] * 10 + [I] * 8 + [F, P]
    lib.flash_attention_bwd.restype = I
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


def _launch(q, k, v, causal: bool, window: int, with_lse: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, the rows' log-sum-exp (B, H, Sq) f32 if ``with_lse``).  out is
    in q's dtype, or with ``with_lse`` in f32: the values that the serving
    entry rounds to q's dtype (the backward reads them)."""
    check_strides("flash_attention", q, k, v)
    (b, sq, h, d), skv, kh = q.shape, k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), device=q.device,
                      dtype=torch.float32 if with_lse else q.dtype)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], b, sq, skv, h, kh, d, int(causal), window,
            d ** -0.5, None if lse is None else lse.data_ptr(), stream)
    raise_on_error("flash_attention", err)
    flash_attention.launches += 1
    flash_attention.launches_by_mask[
        "causal" if causal else "non_causal"] += 1
    flash_attention.launches_by_dtype[dtype_name(q.dtype)] += 1
    flash_attention.launches_windowed += int(window > 0)
    return out, lse


def _heads(*ts: torch.Tensor):
    return [t.transpose(1, 2) for t in ts]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, starting at a multiple of 16 bytes (the
    gradient kernel copies rows with 16-byte ``cp.async``)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_bwd(q, k, v, out, lse, dout, causal: bool, window: int):
    q, k, v, out, lse, dout = (_aligned(t)
                               for t in (q, k, v, out, lse, dout))
    (b, sq, h, d), skv, kh = q.shape, k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    di = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_lib().flash_attention_bwd(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, kh, d, int(causal),
            window, d ** -0.5, stream)
    raise_on_error("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_dtype[dtype_name(q.dtype)] += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` at q (B, Sq, H, D), k, v
    (B, Skv, KH, D), given its output ``out`` (B, Sq, H, D) in f32, before
    any rounding to q's dtype (what the forward asked for its lse
    returns), the rows' log-sum-exp ``lse`` (B, H, Sq) f32 and ``dout``
    (B, Sq, H, D); q, k, v and dout all f32 or all bf16, the gradients in
    their dtype.  CUDA tensors launch ``csrc/flash_attention_bwd.cu``, CPU
    tensors take ``flash_attention_bwd_ref``."""
    _check(q, k, v, window)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} for q {tuple(q.shape)}")
    if dout.dtype != q.dtype or out.dtype != torch.float32 or \
            lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd takes dout of q's dtype "
                        f"{q.dtype} and an f32 out and lse, got "
                        f"{dout.dtype}, {out.dtype}, {lse.dtype}")
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, out, lse, dout, causal, window)
    if q.device.type == "cpu":
        grads = flash_attention_bwd_ref(*_heads(q, k, v, out), lse,
                                        *_heads(dout), causal=causal,
                                        window=window)
        return tuple(_heads(*grads))
    raise ValueError(f"unsupported device {q.device}")


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_dtype = {"float32": 0, "bfloat16": 0}


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the kernels on the card, the
    plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        """Saves the f32 output (before its rounding to q's dtype) and the
        rows' lse for the backward."""
        if q.device.type == "cuda":
            out, lse = _launch(q, k, v, causal, window, with_lse=True)
        else:
            qh, kh, vh = _heads(q, k, v)
            out = flash_attention_ref(qh.float(), kh.float(), vh.float(),
                                      causal=causal,
                                      window=window).transpose(1, 2)
            lse = flash_attention_lse_ref(qh, kh, causal=causal,
                                          window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KH, D) -> (B, Sq, H, D) in q's dtype.

    Positions count from 0 for q and for k: ``causal`` keeps k <= q and a
    ``window`` > 0 keeps k > q - window."""
    _check(q, k, v, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)[0]
    if q.device.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window)
        return out.transpose(1, 2)
    raise ValueError(f"unsupported device {q.device}")


flash_attention.launches = 0
flash_attention.launches_by_mask = {"causal": 0, "non_causal": 0}
flash_attention.launches_by_dtype = {"float32": 0, "bfloat16": 0}
flash_attention.launches_windowed = 0
