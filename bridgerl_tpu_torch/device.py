"""Device resolution: the port runs on the card unless the caller asks for
the CPU, and never falls back from one to the other on its own. Data
parallel, each local rank runs on a card of its own (:func:`local_rank_device`)."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def local_rank_device(local_rank: int) -> torch.device:
    """The card of local rank ``local_rank``: ``cuda:{local_rank}``. Raises
    without CUDA or when this host has no such card."""
    dev = resolve_device(torch.device("cuda", local_rank))
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local_rank} has no card: this host has "
                           f"{torch.cuda.device_count()}")
    return dev
