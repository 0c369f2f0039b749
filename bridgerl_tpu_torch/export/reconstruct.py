"""Long-sequence reconstruction: sliding windows, one model call, overlap-add.

Counterpart of ``bridgerl_tpu/export/reconstruct.py``. Every window of the
sequence is gathered into one batch on the device, the model runs once, and
the predictions are summed back into place with ``index_add_`` and divided
by how many windows cover each frame. Window placement is the reference's:
starts at 0, step ``step``, while ``start + window <= T``, plus one tail
window at ``T - window`` when the sweep stopped short.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from .streaming import window_starts

ApplyFn = Callable[[torch.Tensor], torch.Tensor]


@torch.inference_mode()
def reconstruct_long_sequence(apply_fn: ApplyFn, full_seq: np.ndarray, window: int,
                              step_size: int, mean: np.ndarray, std: np.ndarray,
                              device=None) -> Optional[np.ndarray]:
    """Overlap-add reconstruction of a (T, D) sequence on ``device`` (the
    card by default); None if T <= window (the caller then takes
    :func:`reconstruct_single_window`, as the reference does).

    ``apply_fn`` maps normalised (K, W, D) windows to (K, W, D) windows."""
    seq_len = int(full_seq.shape[0])
    if seq_len <= window:
        return None
    dev = resolve_device(device)
    seq = torch.as_tensor(np.asarray(full_seq, np.float32), device=dev)
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=dev)
    starts = torch.as_tensor(window_starts(seq_len, window, step_size),
                             dtype=torch.long, device=dev)
    idx = starts[:, None] + torch.arange(window, device=dev)[None, :]   # (K, W)
    recon = apply_fn((seq[idx] - mean_t) / std_t) * std_t + mean_t      # (K, W, D)
    flat_idx = idx.reshape(-1)
    D = recon.shape[-1]
    buf = torch.zeros(seq_len, D, device=dev).index_add_(0, flat_idx, recon.reshape(-1, D))
    cnt = torch.zeros(seq_len, 1, device=dev).index_add_(
        0, flat_idx, torch.ones(flat_idx.shape[0], 1, device=dev))
    return (buf / torch.clamp(cnt, min=1.0)).cpu().numpy()


@torch.inference_mode()
def reconstruct_single_window(apply_fn: ApplyFn, sample: np.ndarray, window: int,
                              mean: np.ndarray, std: np.ndarray,
                              device=None) -> np.ndarray:
    """Short path: the first ``window`` frames through the model once."""
    dev = resolve_device(device)
    chunk = torch.as_tensor(np.asarray(sample[:window], np.float32), device=dev)[None]
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=dev)
    recon = apply_fn((chunk - mean_t) / std_t) * std_t + mean_t
    return recon[0].cpu().numpy()
