"""Preprocessing: paired npz motions -> windowed npy artifacts and their
normalisation statistics.

The port's own copy of ``bridgerl_tpu/data/pipeline.py``, with the same
artifact contract (what training, export and evaluation read):

    g1_train.npy            (N, W, 29)  float32 robot joint windows
    human_train.npy         (N, W, 126) float32 human 6D-rotation windows
    g1_train_full_raw.npy   object array of variable-length (T, 29) sequences
    mean.npy / std.npy      per-dim robot statistics (std + 1e-6)
    human_mean.npy / human_std.npy
"""

from __future__ import annotations

import glob
import os
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from .rotations import compute_6d_rotation

ARTIFACTS = (
    "g1_train.npy",
    "human_train.npy",
    "g1_train_full_raw.npy",
    "mean.npy",
    "std.npy",
    "human_mean.npy",
    "human_std.npy",
)


def slice_windows(motion: np.ndarray, window: int, stride: int) -> np.ndarray:
    """All windows of ``window`` frames at ``stride``: (K, window, D), built
    as a strided view and one copy."""
    T = motion.shape[0]
    if T < window:
        return np.empty((0, window) + motion.shape[1:], dtype=motion.dtype)
    starts = np.arange(0, T - window + 1, stride)
    view = np.lib.stride_tricks.sliding_window_view(motion, window, axis=0)
    # the window axis comes last: (T-W+1, D, W) -> (K, W, D)
    return np.ascontiguousarray(np.moveaxis(view[starts], -1, 1))


def process_paired_data(
    input_dir: str,
    output_dir: str,
    window: int = 64,
    step: int = 20,
    overwrite: bool = False,
    verbose: bool = True,
) -> Optional[Dict[str, np.ndarray]]:
    """Walk the ``train*`` subdirectories of ``input_dir`` for paired npz
    files and write the artifact set. An npz counts when it has both
    ``joint_pos`` (robot, (T, 29)) and ``smplx_pose_body`` (human pose); the
    two streams are cut to one length, files with NaNs are skipped, both are
    windowed at (window, step), and robot sequences of at least ``window``
    frames are also kept whole. Returns None when the artifacts exist
    (without ``overwrite``) or nothing usable was found."""
    main_file = os.path.join(output_dir, "g1_train.npy")
    raw_file = os.path.join(output_dir, "g1_train_full_raw.npy")
    if os.path.exists(main_file) and os.path.exists(raw_file) and not overwrite:
        if verbose:
            print(f"Data already exists in {output_dir}; skipping (use overwrite to force).")
        return None

    subdirs = [d for d in os.listdir(input_dir) if os.path.isdir(os.path.join(input_dir, d))]
    train_dirs = [d for d in subdirs if "train" in d.lower()]
    if not train_dirs:
        if verbose:
            print(f"Warning: no train directories under {input_dir}")
        return None

    os.makedirs(output_dir, exist_ok=True)
    robot_slices: List[np.ndarray] = []
    human_slices: List[np.ndarray] = []
    robot_raw: List[np.ndarray] = []

    for d in train_dirs:
        for f in sorted(glob.glob(os.path.join(input_dir, d, "**", "*.npz"), recursive=True)):
            try:
                data = np.load(f, allow_pickle=True)
                if "joint_pos" not in data or "smplx_pose_body" not in data:
                    continue
                robot = np.asarray(data["joint_pos"])
                if robot.ndim > 2:
                    robot = robot.reshape(robot.shape[0], -1)
                human = compute_6d_rotation(np.asarray(data["smplx_pose_body"]))
                n = min(len(robot), len(human))
                robot, human = robot[:n], human[:n]
                if np.isnan(robot).any() or np.isnan(human).any():
                    continue
                if n >= window:
                    robot_raw.append(robot.astype(np.float32))
                r = slice_windows(robot, window, step)
                h = slice_windows(human, window, step)
                if len(r) == len(h) and len(r) > 0:
                    robot_slices.append(r)
                    human_slices.append(h)
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile) as e:   # a bad file skips that file only
                if verbose:
                    print(f"Error reading {f}: {e}")

    if not robot_slices:
        if verbose:
            print("Error: no usable data found.")
        return None

    robot_data = np.concatenate(robot_slices).astype(np.float32)
    human_data = np.concatenate(human_slices).astype(np.float32)
    arrays = save_artifacts(output_dir, robot_data, human_data, robot_raw)
    if verbose:
        print(f"Processed: robot {robot_data.shape}, human {human_data.shape}, "
              f"{len(robot_raw)} full sequences -> {output_dir}")
    return arrays


def save_artifacts(
    output_dir: str,
    robot_data: np.ndarray,
    human_data: np.ndarray,
    robot_raw: List[np.ndarray],
) -> Dict[str, np.ndarray]:
    """Write the artifact set: the windows, the raw sequences, and per-dim
    mean and std over all frames (std + 1e-6)."""
    os.makedirs(output_dir, exist_ok=True)
    r_flat = robot_data.reshape(-1, robot_data.shape[-1])
    h_flat = human_data.reshape(-1, human_data.shape[-1])
    arrays = {
        "g1_train.npy": robot_data,
        "human_train.npy": human_data,
        "mean.npy": np.mean(r_flat, axis=0),
        "std.npy": np.std(r_flat, axis=0) + 1e-6,
        "human_mean.npy": np.mean(h_flat, axis=0),
        "human_std.npy": np.std(h_flat, axis=0) + 1e-6,
    }
    for name, arr in arrays.items():
        np.save(os.path.join(output_dir, name), arr)
    # as np.array builds it: 1-D of sequences when their lengths differ,
    # (n, T, 29) of objects when they are all alike
    raw = np.array(robot_raw, dtype=object)
    np.save(os.path.join(output_dir, "g1_train_full_raw.npy"), raw, allow_pickle=True)
    arrays["g1_train_full_raw.npy"] = raw
    return arrays


def load_artifacts(data_dir: str) -> Dict[str, np.ndarray]:
    """The processed artifact set; raises if the window pair is missing."""
    out: Dict[str, np.ndarray] = {}
    for name in ("g1_train.npy", "human_train.npy"):
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            raise FileNotFoundError(f"Missing data artifact {path}; run process_data first.")
        out[name] = np.load(path).astype(np.float32)
    for name in ("mean.npy", "std.npy", "human_mean.npy", "human_std.npy"):
        path = os.path.join(data_dir, name)
        if os.path.exists(path):
            out[name] = np.load(path).astype(np.float32)
    raw_path = os.path.join(data_dir, "g1_train_full_raw.npy")
    if os.path.exists(raw_path):
        out["g1_train_full_raw.npy"] = np.load(raw_path, allow_pickle=True)
    return out


def inspect_npz(path: str) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Key -> (shape, dtype) of an npz file."""
    data = np.load(path, allow_pickle=True)
    return {k: (tuple(np.asarray(data[k]).shape), str(np.asarray(data[k]).dtype))
            for k in data.files}
