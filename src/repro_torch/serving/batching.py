"""Continuous batching for the generation model, on PyTorch.

Port of ``repro.serving.batching``.  A fixed pool of ``num_slots`` decode
slots shares one batched cache (one :class:`~repro_torch.models.cache.
KVCache` per attention layer, (num_slots, max_len, KH, D), or a ring of
the window's rows for a sliding-window layer, one for each application of
a shared block; one :class:`~repro_torch.models.rwkv6.RwkvCache` per
``"rwkv6"`` layer, the state and shift carries of each slot; one
:class:`~repro_torch.models.mamba2.MambaCache` per ``"mamba2"`` layer, the
SSM state and conv carry of each slot).  A request is admitted into a free
slot: the slot's row is zeroed and its prompt prefilled alone, at its own
unpadded length, into views of that row, so a reused slot holds what a
fresh cache would after the same prefill (the reference copies a fresh
prefilled cache into the slot).  One decode step (a tick)
advances every slot one token with per-slot cache lengths, free slots
included, as the reference does; a finished slot (its budget of tokens, or
the cache's last position) is freed at once for the next waiting request.
No batch-wide barrier.  Any registered config runs: a mixture-of-experts
model routes every slot's token in a tick, free slots' included, and
decode is dropless (capacity = slots), so no slot takes another's
capacity; an admission's prefill runs alone, at the config's factor; an
RWKV6 or Mamba2 layer advances every slot's state in a tick, free slots'
included, and an admission starts its slot's state from zeros (every
cache's ``fresh_row``).

On the card every layer of an admission's prefill runs the prefill
attention kernel (``flash_attention``, causal, at (1, L, H, D)) and every
layer of a tick the decode kernel (``decode_attention``) with (num_slots,)
lengths that differ from slot to slot (an ``"rwkv6"`` or ``"mamba2"``
layer none).  Nothing here catches a kernel's error: a card run never
takes a plain version.

``compute_dtype`` (float32 by default) is the reference's: every prefill
and decode step computes in it, over caches that stay ``init_cache``'s
default f32, as the reference's are (so a bf16 step's decode attention on
the card is the f32 kernel entry on q widened to f32, and an ``"rwkv6"``
model refuses bf16 here, as the reference's batcher does: its layer scan
raises over f32 shift caches).  The greedy token is ``argmax``, whose
first index wins a tie, as ``jnp.argmax``'s does: bf16 logits tie more
often.

``lens`` and ``next_tok`` stay numpy arrays on the host, as in the
reference.  A tick copies the slots' greedy tokens back to the host once.

The one departure from the reference: :meth:`ContinuousBatcher.admit`
refuses lengths the reference takes without a check, raising
``ValueError`` before any launch for an empty prompt, for ``max_len -
max_new_tokens - 1 < 1`` (a budget that leaves no room for the prompt) and
for a budget under 1.  With the first two the reference slices the prompt
from its end and decodes at negative cache positions, which the decode
kernel refuses (a length under 1); with a budget of 0 it returns one token
and may leave a freed slot at ``max_len``, past the cache, where the next
tick's insert would index out of bounds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.models import Model, decode_step, init_cache, prefill


@dataclasses.dataclass
class SlotState:
    request_id: int = -1
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    budget: int = 0

    @property
    def free(self) -> bool:
        return self.request_id < 0


class ContinuousBatcher:
    """``params`` is a port :class:`Model` already on ``device`` (the card
    unless ``"cpu"``), in any dtype; the model computes in
    ``compute_dtype``."""

    def __init__(self, cfg: ModelConfig, params: Model, *,
                 num_slots: int = 4, max_len: int = 256,
                 compute_dtype=torch.float32, device: DeviceLike = None):
        self.device = resolve_device(device)
        if not same_device(params.device, self.device):
            raise ValueError(f"params are on {params.device}, the batcher "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.caches = init_cache(cfg, num_slots, max_len, device=self.device)
        self.lens = np.zeros(num_slots, np.int32)       # per-slot cache len
        self.next_tok = np.zeros(num_slots, np.int32)
        self.slots = [SlotState() for _ in range(num_slots)]
        self.completed: Dict[int, List[int]] = {}

    def admit(self, request_id: int, prompt_tokens: List[int],
              max_new_tokens: int) -> Optional[int]:
        """Prefill into a free slot; returns the slot or None if full.
        Raises ``ValueError`` (before any launch) for an empty prompt, a
        budget under 1, or a budget that leaves the prompt no position."""
        room = self.max_len - max_new_tokens - 1
        if room < 1 or max_new_tokens < 1 or not len(prompt_tokens):
            raise ValueError(
                f"request {request_id}: needs a prompt and 1 <= "
                f"max_new_tokens <= max_len - 2 = {self.max_len - 2}; got "
                f"{len(prompt_tokens)} prompt tokens and max_new_tokens="
                f"{max_new_tokens}")
        free = [i for i, s in enumerate(self.slots) if s.free]
        if not free:
            return None
        slot = free[0]
        L = min(len(prompt_tokens), room)
        toks = torch.tensor([list(prompt_tokens[:L])], dtype=torch.long,
                            device=self.device)
        # prefill straight into the slot's row, zeroed first: positions L
        # and beyond hold zeros and a recurrent state starts from zeros, as
        # in the reference's copy of a fresh row
        rows = [c.fresh_row(slot) for c in self.caches]
        last_logits, _ = prefill(self.params, {"tokens": toks}, rows,
                                 compute_dtype=self.compute_dtype)
        self.lens[slot] = L
        self.next_tok[slot] = int(last_logits[0].argmax())
        self.slots[slot] = SlotState(request_id=request_id,
                                     budget=max_new_tokens)
        return slot

    def tick(self) -> int:
        """One decode step for all slots; returns #active."""
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if not active:
            return 0
        toks = torch.from_numpy(self.next_tok.astype(np.int64)).to(
            self.device).reshape(-1, 1)
        lens = torch.from_numpy(self.lens.astype(np.int64)).to(self.device)
        logits, _ = decode_step(self.params, toks, self.caches, lens,
                                compute_dtype=self.compute_dtype)
        nxt = logits.argmax(-1).cpu().numpy()           # one copy a tick
        for i in active:
            s = self.slots[i]
            s.tokens_out.append(int(self.next_tok[i]))
            self.lens[i] += 1
            self.next_tok[i] = nxt[i]
            if (len(s.tokens_out) >= s.budget
                    or self.lens[i] >= self.max_len - 1):
                self.completed[s.request_id] = s.tokens_out
                self.slots[i] = SlotState()     # free immediately
        return len(active)

    def run(self, requests: List[Dict], tick_limit: int = 10_000
            ) -> Dict[int, List[int]]:
        """requests: [{id, prompt_tokens, max_new_tokens}] -> outputs."""
        pending = list(requests)
        ticks = 0
        while (pending or any(not s.free for s in self.slots)) \
                and ticks < tick_limit:
            while pending:
                r = pending[0]
                if self.admit(r["id"], r["prompt_tokens"],
                              r["max_new_tokens"]) is None:
                    break
                pending.pop(0)
            self.tick()
            ticks += 1
        return self.completed
