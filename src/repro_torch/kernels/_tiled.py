"""Host side of the one-launch top-k kernels (``csrc/topk_tiled.cuh``:
``ivf_topk`` and fp32 ``slab_topk``): their one launcher, ``launch``, and
the counters it hands them.

A launch counts on zeroed counters: one per query tile (the block that
brings it to the tile count is the last and merges) and one per query (it
hands out the offsets of the query's candidates).  The merging block sets
them back to 0 when it is done.  So each (card, stream) keeps one zeroed
int32 array, made when a stream first needs it or needs a longer one (the
only extra launch) and reused by every later launch on that stream, which
runs after the previous one has reset it.  Two streams never share one.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _stream_and_tickets(dev: torch.device, nq: int) -> Tuple[int, int, int]:
    """(the current stream's handle on ``dev``, the address and the length
    of its zeroed counters: at least ``2 * nq``, which covers the ceil(nq /
    16) tile counters and the nq query counters)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _tickets.get((dev.index, stream))
    if tickets is None or tickets.numel() < 2 * nq:
        tickets = _tickets[dev.index, stream] = torch.zeros(
            max(2 * nq, 4096), dtype=torch.int32, device=dev)
    return stream, tickets.data_ptr(), tickets.numel()


def launch(fn: Callable[..., int], scratch_bytes: Callable[[int, int, int],
                                                           int],
           emb: torch.Tensor, queries: torch.Tensor,
           virt: Optional[torch.Tensor], k: int):
    """One launch of the C entry ``fn`` (``ivf_topk``, or ``slab_topk_fp32``
    with ``virt``) on float32 emb (N, D) and queries (Q, D) of one card ->
    (vals (Q, k) f32, rows (Q, k) int32).  ``scratch_bytes(n, nq, k)`` sizes
    the one scratch allocation; a failed launch raises."""
    emb, queries = emb.contiguous(), queries.contiguous()
    (n, d), nq = emb.shape, queries.shape[0]
    dev = emb.device
    head = (emb.data_ptr(), queries.data_ptr())
    if virt is not None:
        virt = virt.contiguous()
        head += (virt.data_ptr(),)
    scratch = torch.empty(scratch_bytes(n, nq, k), dtype=torch.uint8,
                          device=dev)
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    rows = torch.empty((nq, k), dtype=torch.int32, device=dev)

    def call():
        stream, tickets, ntickets = _stream_and_tickets(dev, nq)
        return fn(*head, n, d, nq, k, scratch.data_ptr(), tickets, ntickets,
                  vals.data_ptr(), rows.data_ptr(), stream)

    # the launch goes to the current card, so another card's tensors switch
    # to theirs first
    if dev.index == torch.cuda.current_device():
        err = call()
    else:
        with torch.cuda.device(dev):
            err = call()
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError "
                           f"{err}")
    return vals, rows
