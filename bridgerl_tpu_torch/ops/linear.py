"""The seed-stacked layout's one rule, and ``F.linear`` over a seed-stacked
batch."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def seed_count(module: nn.Module) -> Optional[int]:
    """S for a module of a seed-stacked model (``models/stacked.py``), else
    None. Every module that computes differently when stacked asks this."""
    return getattr(module, "stacked_seeds", None)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           seeds: Optional[int] = None) -> torch.Tensor:
    """``F.linear``; with ``seeds`` S, (S, out, in) weights and (S, out)
    biases (``models/stacked.py``), per seed over the S seed-major groups of
    x's rows, as one batched product (JAX's vmapped ``Dense``)."""
    if seeds is None:
        return F.linear(x, weight, bias)
    y = torch.baddbmm(bias[:, None, :], x.reshape(seeds, -1, x.shape[-1]),
                      weight.transpose(1, 2))
    return y.reshape(*x.shape[:-1], weight.shape[1])
