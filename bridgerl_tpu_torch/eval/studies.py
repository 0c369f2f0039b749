"""What the token-prior studies (``cli/exp_prior_*.py``) share: loading the
teacher, the priors and the takes, the phases of a tokenization, the
data-window banks, decoding grid rows back to windows, the decode+stitch
ceiling, and reproducing the take-grouped split of a prior's training run.

Every study tokenizes the raw pipeline (mean 0, std 1: the distribution the
teacher was trained on) on the stride grid, so these helpers take raw takes
and return raw windows.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

# the raw pipeline: windows enter the teacher as they are
RAW_MEAN = np.zeros(1, np.float32)
RAW_STD = np.ones(1, np.float32)


def load_teacher(prog: str, path: str, device):
    """(model, experiment) of a port checkpoint (``.pth``) on ``device``, or
    None after saying on stderr why the file is not one. The JAX package's
    ``.ckpt`` is refused: ``scripts/export_torch_ckpt.py`` writes its
    learned tensors as a reference ``.pth``, which ``cli.import_torch_ckpt``
    turns into a port checkpoint."""
    from ..export.motion_export import load_model_from_checkpoint

    try:
        return load_model_from_checkpoint(path, device=device)
    except Exception as e:   # any unreadable file: say why and stop
        print(f"{prog}: {path} is not a checkpoint of bridgerl_tpu_torch ({e}); a JAX "
              "package .ckpt converts through scripts/export_torch_ckpt.py and then "
              "python -m bridgerl_tpu_torch.cli.import_torch_ckpt", file=sys.stderr)
        return None


def load_priors(prog: str, paths: Sequence[str], device):
    """[(name, prior model, its config)] for the comma list's files, or None
    after saying on stderr which file is not a port prior checkpoint."""
    from ..train.prior import load_prior_checkpoint

    out = []
    for path in paths:
        try:
            model, pcfg = load_prior_checkpoint(path, device=device)
        except ValueError as e:
            print(f"{prog}: {e}", file=sys.stderr)
            return None
        out.append((Path(path).stem, model, pcfg))
    return out


def load_takes(data_dir: str) -> List[np.ndarray]:
    """The full-raw robot takes of ``data_dir`` (``g1_train_full_raw.npy``)."""
    return list(np.load(Path(data_dir) / "g1_train_full_raw.npy", allow_pickle=True))


def phase_offsets(stride: int, n_phases: int) -> List[int]:
    """``n_phases`` evenly spaced start offsets in [0, stride)."""
    return sorted({round(i * stride / n_phases) for i in range(n_phases)})


def window_bank(takes: Sequence[np.ndarray], window: int, stride: int,
                keep: Optional[Sequence[int]] = None) -> np.ndarray:
    """Every raw window on the stride grid of the takes (of the take indices
    ``keep``, in that order, when given), skipping takes shorter than a
    window: the yardstick of nearest-window distances."""
    idx = range(len(takes)) if keep is None else keep
    takes = [np.asarray(takes[i], np.float32) for i in idx]
    return np.concatenate([np.stack([s[i:i + window]
                                     for i in range(0, s.shape[0] - window + 1, stride)])
                           for s in takes if s.shape[0] >= window])


def decode_grid_rows(vq_model, exp, pcfg, grid_rows: np.ndarray) -> np.ndarray:
    """(B, N, S) normalised grid rows -> (B, N, W, D) raw decoded windows
    (code decode and the teacher's decoder, on the teacher's device)."""
    from ..train.prior import decode_grid

    dev = next(vq_model.parameters()).device
    grid = torch.as_tensor(np.asarray(grid_rows, np.int64), device=dev)
    B, N, _ = grid.shape
    mean, std = (torch.as_tensor(a, device=dev) for a in (RAW_MEAN, RAW_STD))
    with torch.inference_mode():
        wins = decode_grid(vq_model, exp, pcfg, grid, mean, std)
    return wins.cpu().numpy().reshape(B, N, pcfg.window, -1)


def decode_ceiling(vq_model, exp, grids: np.ndarray, mask: np.ndarray, pcfg,
                   takes: Sequence[np.ndarray], stride: int, n_grids: int = 8) -> dict:
    """The decode+stitch ceiling: the first ``n_grids`` grids (the data's own
    codes) decoded and stitched, scored against the takes
    (``compare_to_data``), with their mean overlap disagreement and their
    decoded windows' nearest raw window on the stride grid (the nn_mse a
    verbatim copy would score)."""
    from .generation import compare_to_data, nearest_data_distance, overlap_disagreement
    from ..train.prior import stitch_windows

    motions, dis, wins = [], [], []
    for i in range(min(n_grids, grids.shape[0])):
        w = decode_grid_rows(vq_model, exp, pcfg, grids[i:i + 1, :int(mask[i].sum())])[0]
        motions.append(stitch_windows(w, stride))
        dis.append(overlap_disagreement(w, stride))
        wins.append(w)
    ceiling = compare_to_data(motions, takes)
    ceiling["overlap_disagreement"] = float(np.mean(dis))
    ceiling.update(nearest_data_distance(np.concatenate(wins),
                                         window_bank(takes, exp.model.window_size, stride)))
    return ceiling


def grouped_val_takes(seq_ids: np.ndarray, seed: int, val_fraction: float = 0.1) -> Set[int]:
    """The validation takes of ``train_prior``'s take-grouped split at
    ``seed`` (the same generator and draw)."""
    rng = np.random.default_rng(seed)
    takes = rng.permutation(np.unique(seq_ids))
    n_val = max(1, int(len(takes) * val_fraction)) if len(takes) > 1 else 0
    return set(takes[:n_val].tolist())


def held_out_rows(is_val: np.ndarray, mask: np.ndarray, positions: int,
                  n_samples: int) -> Tuple[np.ndarray, int]:
    """(rows, n_pos): up to ``n_samples`` validation grid rows spread evenly
    over those with ``positions`` valid positions (any with 2 when none
    has), and the positions all of them hold, at most ``positions``."""
    rows = np.nonzero(is_val & (mask.sum(1) >= positions))[0]
    if rows.size == 0:
        rows = np.nonzero(is_val & (mask.sum(1) >= 2))[0]
    sel = rows[np.linspace(0, rows.size - 1, min(n_samples, rows.size)).astype(int)]
    return sel, min(positions, int(mask[sel].sum(1).min()))
