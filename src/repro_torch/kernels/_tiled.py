"""Host side of the kernels that merge their blocks' partial results in the
same launch: the one-launch top-k kernels (``csrc/topk_tiled.cuh``:
``ivf_topk`` and ``slab_topk`` in every mode, launched by :func:`launch`)
and the split-K decode attention kernels (``csrc/decode_attention.cu``: K6
and K7).

A launch counts on zeroed counters: the block that brings a group's counter
to the group's block count is the last, and merges (a top-k query tile, or
a decode (slot, kv head); the top-k kernels also hand out each query's
candidate offsets from one).  The merging block sets them back to 0 when it
is done.  So each (card, stream) keeps one zeroed int32 array
(:func:`stream_and_tickets`), made when a stream first needs it or needs a
longer one (the only extra launch) and reused by every later launch on that
stream, which runs after the previous one has reset it; and one scratch
buffer for the partials (:func:`stream_scratch`), which a launch writes and
reads before the next one on the stream starts.  Two streams never share
either.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_tickets: Dict[Tuple[int, int], torch.Tensor] = {}
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def stream_and_tickets(dev: torch.device, n: int) -> Tuple[int, int, int]:
    """(the current stream's handle on ``dev``, the address and the length
    of its zeroed counters: at least ``n``)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _tickets.get((dev.index, stream))
    if tickets is None or tickets.numel() < n:
        tickets = _tickets[dev.index, stream] = torch.zeros(
            max(n, 4096), dtype=torch.int32, device=dev)
    return stream, tickets.data_ptr(), tickets.numel()


def stream_scratch(dev: torch.device, stream: int,
                   nbytes: int) -> Tuple[int, int]:
    """(the address and the size in bytes of the scratch buffer of
    ``stream`` on ``dev``: at least ``nbytes``, on a 16-byte boundary)."""
    buf = _scratch.get((dev.index, stream))
    if buf is None or buf.numel() < nbytes:
        buf = _scratch[dev.index, stream] = torch.empty(
            max(nbytes, 1 << 16), dtype=torch.uint8, device=dev)
    return buf.data_ptr(), buf.numel()


def on_card(dev: torch.device, call: Callable[[], int]) -> int:
    """``call()`` with ``dev`` the current card: a launch goes to the
    current card, so another card's tensors switch to theirs first (and
    only then, since entering ``torch.cuda.device`` costs host time)."""
    if dev.index == torch.cuda.current_device():
        return call()
    with torch.cuda.device(dev):
        return call()


def launch(fn: Callable[..., int], scratch_bytes: Callable[[int, int, int],
                                                           int],
           operands: Sequence[Optional[torch.Tensor]], n: int, width: int,
           nq: int, k: int):
    """One launch of the C entry ``fn`` (``ivf_topk``, or a ``slab_topk``
    mode's), whose leading arguments are the addresses of ``operands``
    (tensors of one card, made contiguous here; None passes a null
    pointer), then n, ``width`` (D, or pq's m), nq and k -> (vals (Q, k)
    f32, rows (Q, k) int32).  ``scratch_bytes(n, nq, k)`` sizes the one
    scratch allocation; a failed launch raises."""
    ops = [None if t is None else t.contiguous() for t in operands]
    dev = ops[0].device
    ptrs = [None if t is None else t.data_ptr() for t in ops]
    scratch = torch.empty(scratch_bytes(n, nq, k), dtype=torch.uint8,
                          device=dev)
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    rows = torch.empty((nq, k), dtype=torch.int32, device=dev)

    def call():
        # ceil(nq / 16) tile counters and nq query counters
        stream, tickets, ntickets = stream_and_tickets(dev, 2 * nq)
        return fn(*ptrs, n, width, nq, k, scratch.data_ptr(), tickets,
                  ntickets, vals.data_ptr(), rows.data_ptr(), stream)

    err = on_card(dev, call)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError "
                           f"{err}")
    return vals, rows
