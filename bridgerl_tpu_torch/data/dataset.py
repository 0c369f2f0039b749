"""Paired dataset resident on the device, deterministic split, batching.

Counterpart of ``bridgerl_tpu/data/dataset.py``. The whole dataset, robot
(N, W, 29) and human (N, W, 126) windows, lives on the device once, and
batches are on-device gathers: there is no DataLoader and no host copy per
step. ``split_indices`` is numpy and gives the JAX package's split exactly;
the per-epoch shuffles come from a ``torch.Generator`` and cannot match
``jax.random`` bit for bit.

Data-parallel (``parallel/``), every rank holds the whole dataset on its
own device, draws the same index matrices, and gathers only its contiguous
share of each train or validation batch (``parallel.shard_rows``), as the
JAX package's ``shard_batch`` pins a gathered batch to the ``data`` axis;
:func:`require_split` refuses a batch that the ranks do not divide.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import parallel
from ..device import resolve_device


@dataclass
class PairedDataset:
    """Paired robot/human windows on one device."""

    robot: torch.Tensor  # (N, W, Dr)
    human: torch.Tensor  # (N, W, Dh)

    @classmethod
    def from_numpy(cls, robot: np.ndarray, human: np.ndarray,
                   device=None) -> "PairedDataset":
        """Truncates to the shorter of the two, as the reference does."""
        dev = resolve_device(device)
        n = min(len(robot), len(human))
        as_t = lambda a: torch.as_tensor(np.asarray(a[:n], np.float32)).to(dev)
        return cls(robot=as_t(robot), human=as_t(human))

    def __len__(self) -> int:
        return self.robot.shape[0]

    @property
    def robot_dim(self) -> int:
        return int(self.robot.shape[-1])

    @property
    def human_dim(self) -> int:
        return int(self.human.shape[-1])


def split_indices(n: int, val_fraction: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic host-side train/val index split (90/10 by default)."""
    rng = np.random.default_rng(np.uint32(seed))
    perm = rng.permutation(n)
    train_size = int((1.0 - val_fraction) * n)
    return perm[:train_size], perm[train_size:]


def train_val_split(ds: PairedDataset, val_fraction: float, seed: int
                    ) -> Tuple[PairedDataset, PairedDataset]:
    tr, va = (torch.as_tensor(a).to(ds.robot.device)
              for a in split_indices(len(ds), val_fraction, seed))
    return (PairedDataset(ds.robot[tr], ds.human[tr]),
            PairedDataset(ds.robot[va], ds.human[va]))


def epoch_batch_indices(generator: torch.Generator, n: int, batch_size: int
                        ) -> torch.Tensor:
    """Shuffled (num_batches, batch_size) index matrix for one epoch, on the
    generator's device; the tail that does not fill a batch is dropped."""
    perm = torch.randperm(n, generator=generator, device=generator.device)
    num_batches = n // batch_size
    return perm[: num_batches * batch_size].reshape(num_batches, batch_size)


def require_split(rows: int, what: str) -> None:
    """Raise unless the data-parallel ranks divide a batch of ``rows``."""
    R = parallel.world_size()
    if rows % R:
        raise ValueError(f"{what} of {rows} windows does not split over {R} ranks: "
                         f"choose sizes whose batches are multiples of {R}")

