"""Assigned input shapes.

Each shape names the step function that is lowered for it in the dry-run:
  * ``train``   -> ``train_step``   (loss + grads + optimizer update)
  * ``prefill`` -> ``prefill_step`` (full-sequence forward, KV cache out)
  * ``decode``  -> ``serve_step``   (ONE new token against a seq_len cache)

``long_500k`` additionally requires sub-quadratic attention: SSM/hybrid archs
run natively; all attention archs switch to the sliding-window serving mode
(window 8192) — see DESIGN.md §4.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"
    # decode shapes: cache length is seq_len and the step consumes 1 token
    sliding_window_mode: bool = False


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode",
                            sliding_window_mode=True),
}

# Serving window used by attention archs for long_500k (DESIGN.md §4).
LONG_CONTEXT_WINDOW = 8_192


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
