"""Device selection for the port's entry points.

Every entry point runs on the card (``cuda``) unless its caller asks for the
CPU with ``device="cpu"``.  Without a card and without that request it
raises: nothing in the port silently carries on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Raises if the card is asked for (or
    defaulted to) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:<current>`` are one device."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)
