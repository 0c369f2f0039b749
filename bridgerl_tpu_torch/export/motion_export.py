"""Batch motion export: ground truth and reconstructions from a checkpoint.

Counterpart of ``bridgerl_tpu/export/motion_export.py`` (the reference's
``scripts/deployment/export_motion.py:85-229``), over the port's ``.pth``:
the config travels inside the checkpoint (``config_json``), full-raw
sequences are preferred, each is reconstructed by overlap-add (or by the
single-window short path), and the files carry the reference's names,
``idx{i}_gt.npy`` and ``recon_{arch}_FullSeq_W{w}_idx{i}.npy`` (short path:
``recon_{arch}_W{w}_{method}_idx{i}.npy``). The model runs on the card
unless ``device="cpu"`` asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..device import resolve_device
from ..models.dual_vqvae import DualMotionVQVAE, init_model
from ..train.checkpoint import load_checkpoint
from .reconstruct import reconstruct_long_sequence, reconstruct_single_window


def load_model_from_checkpoint(ckpt_path: str, device=None
                               ) -> Tuple[DualMotionVQVAE, ExperimentConfig]:
    """The model rebuilt from the config inside the checkpoint, holding its
    weights, on ``device`` (the card by default) in eval mode."""
    ck = load_checkpoint(ckpt_path)
    if ck["config"] is None:
        raise ValueError(f"Checkpoint {ckpt_path} carries no config; cannot rebuild model")
    exp = ck["config"]
    dev = resolve_device(device)
    model = init_model(exp.model, 0, device="cpu")
    model.load_state_dict(ck["model_state_dict"], strict=True)
    return model.to(dev).eval(), exp


def robot_recon_fn(model: DualMotionVQVAE) -> Callable:
    """(K, W, Dr) normalised windows -> (K, W, Dr) normalised float32
    reconstructions."""

    def apply_fn(norm_windows: torch.Tensor) -> torch.Tensor:
        return model(x_robot=norm_windows)["robot"]["recon"].float()

    return apply_fn


def load_stats(data_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Saved robot stats; the identity where there are none, as the reference
    falls back (export_motion.py:16-23)."""
    try:
        mean = np.load(os.path.join(data_dir, "mean.npy"))
        std = np.load(os.path.join(data_dir, "std.npy"))
    except FileNotFoundError:
        print("[WARN] Stats not found, using identity normalization.")
        return np.zeros(1, np.float32), np.ones(1, np.float32)
    return mean.astype(np.float32), std.astype(np.float32)


def export_motions(ckpt_path: str, data_dir: str = "data/processed",
                   output_dir: str = "motions", start_idx: int = 0, num_samples: int = 1,
                   step_size: Optional[int] = None, max_len: int = -1, verbose: bool = True,
                   ref_normalize: bool = False, device=None) -> List[str]:
    """Write each sample's ground truth and reconstruction; returns the paths.
    ``ref_normalize`` normalises at inference as the reference deployment
    does (export_motion.py:47-53), although models train on raw windows;
    the default is raw in, raw out."""
    dev = resolve_device(device)
    model, exp = load_model_from_checkpoint(ckpt_path, dev)
    window, arch, method = exp.model.window_size, exp.model.arch, exp.model.method
    if step_size is None:
        step_size = max(1, window // 2)
    os.makedirs(output_dir, exist_ok=True)
    if ref_normalize:
        mean, std = load_stats(data_dir)
    else:
        mean, std = np.zeros(1, np.float32), np.ones(1, np.float32)
    apply_fn = robot_recon_fn(model)

    raw_path = os.path.join(data_dir, "g1_train_full_raw.npy")
    sliced_path = os.path.join(data_dir, "g1_train.npy")
    if os.path.exists(raw_path):
        raw_data, is_full = np.load(raw_path, allow_pickle=True), True
    elif os.path.exists(sliced_path):
        raw_data, is_full = np.load(sliced_path), False
    else:
        raise FileNotFoundError(f"No data found in {data_dir}")

    written: List[str] = []
    for i in range(start_idx, start_idx + num_samples):
        if i >= len(raw_data):
            if verbose:
                print(f"[WARN] Index {i} out of bounds (total {len(raw_data)}); stopping.")
            break
        full = np.asarray(raw_data[i], dtype=np.float32)
        if max_len > 0 and full.shape[0] > max_len:
            full = full[:max_len]
        seq_len = full.shape[0]
        gt_path = os.path.join(output_dir, f"idx{i}_gt.npy")
        if seq_len > window and is_full:
            recon = reconstruct_long_sequence(apply_fn, full, window, step_size, mean, std,
                                              device=dev)
            if recon is not None:
                path = os.path.join(output_dir, f"recon_{arch}_FullSeq_W{window}_idx{i}.npy")
                np.save(gt_path, full)
                np.save(path, recon)
                written.extend([gt_path, path])
                continue
        if seq_len < window:
            if verbose:
                print(f"[WARN] Sample {i} length {seq_len} < window {window}; skipping.")
            continue
        sample = full[:window]
        recon = reconstruct_single_window(apply_fn, sample, window, mean, std, device=dev)
        path = os.path.join(output_dir, f"recon_{arch}_W{window}_{method}_idx{i}.npy")
        np.save(gt_path, sample)
        np.save(path, recon)
        written.extend([gt_path, path])

    if verbose:
        print(f"[SUCCESS] Saved {len(written)} files to {output_dir}")
    return written
