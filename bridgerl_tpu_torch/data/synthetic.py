"""Synthetic paired human/robot motion.

The port's own copy of the generators of ``bridgerl_tpu/data/synthetic.py``:
with the same seed they give the same arrays. Smooth multi-sine robot joint
trajectories (29 DoF) and a correlated axis-angle human pose stream (21
joints) share their latent oscillators, so a retargeting map exists; the
human stream goes through the same 6D conversion as real data, and the
artifacts are those of ``pipeline.py``. The public dataset needs the
network, so this is the data the port's CLI runs on without it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .pipeline import save_artifacts, slice_windows
from .rotations import compute_6d_rotation

G1_DOF = 29
HUMAN_JOINTS = 21  # SMPL-X body joints -> 126-D in 6D form


def synth_pair(rng: np.random.Generator, T: int, n_components: int = 4
               ) -> Tuple[np.ndarray, np.ndarray]:
    """One paired (robot (T, 29), human axis-angle (T, 63)) sequence, both
    linear mixes of the same ``n_components`` oscillators."""
    t = np.arange(T, dtype=np.float32)[:, None]  # (T, 1)
    freqs = rng.uniform(0.01, 0.15, size=(1, n_components)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, size=(1, n_components)).astype(np.float32)
    amps = rng.uniform(0.2, 1.0, size=(1, n_components)).astype(np.float32)
    latent = amps * np.sin(2 * np.pi * freqs * t + phases)  # (T, C)

    w_robot = rng.normal(0, 0.6, size=(n_components, G1_DOF)).astype(np.float32)
    robot = latent @ w_robot + 0.05 * rng.normal(0, 1, size=(T, G1_DOF)).astype(np.float32)

    w_human = rng.normal(0, 0.4, size=(n_components, HUMAN_JOINTS * 3)).astype(np.float32)
    human_aa = latent @ w_human
    return robot.astype(np.float32), human_aa.astype(np.float32)


def generate_synthetic_dataset(
    output_dir: str,
    n_sequences: int = 32,
    min_len: int = 120,
    max_len: int = 600,
    window: int = 10,
    step: int = 1,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """``n_sequences`` paired sequences of random length, windowed, written
    as the standard artifact set; returns the arrays."""
    rng = np.random.default_rng(seed)
    robot_slices: List[np.ndarray] = []
    human_slices: List[np.ndarray] = []
    robot_raw: List[np.ndarray] = []
    for _ in range(n_sequences):
        T = int(rng.integers(min_len, max_len + 1))
        robot, human_aa = synth_pair(rng, T)
        human = compute_6d_rotation(human_aa).astype(np.float32)
        if T >= window:
            robot_raw.append(robot)
        r = slice_windows(robot, window, step)
        h = slice_windows(human, window, step)
        if len(r) == len(h) and len(r) > 0:
            robot_slices.append(r)
            human_slices.append(h)
    return save_artifacts(output_dir, np.concatenate(robot_slices),
                          np.concatenate(human_slices), robot_raw)


def synth_robot_takes(n_sequences: int, min_len: int, max_len: int, seed: int
                      ) -> List[np.ndarray]:
    """Fresh raw robot takes from the pinned corpus's distribution, each
    mixing its own oscillator bank (a new linear subspace of the same
    family): the take pool of the prior's corpus-scaling study, seeded apart
    from the pinned data."""
    rng = np.random.default_rng(seed)
    takes: List[np.ndarray] = []
    for _ in range(n_sequences):
        T = int(rng.integers(min_len, max_len + 1))
        takes.append(synth_pair(rng, T)[0])
    return takes


# Per-action latent frequency bands (cycles/frame), slow -> fast: distinct
# tempo bands, as distinct LAFAN actions differ in tempo (the reference's
# dataset names its actions only in its file names). ``cli/gen_datasets.py``
# draws the pinned raw_actions fixtures from the same table.
ACTION_BANDS = {
    "walk": (0.010, 0.030),
    "run": (0.050, 0.080),
    "jump": (0.090, 0.130),
    "dance": (0.030, 0.055),
    "fight": (0.130, 0.170),
    "sprint": (0.080, 0.110),
    "fall": (0.005, 0.015),
}


def synth_labeled_takes(n_per_action: int, min_len: int, max_len: int, seed: int,
                        actions: Tuple[str, ...] = tuple(ACTION_BANDS)
                        ) -> Tuple[List[np.ndarray], List[str]]:
    """Long raw robot takes with action labels: ``synth_pair``'s oscillator
    mixtures with each take's frequencies drawn from its action's band, for
    the conditioned prior's scaling study. Each action draws from its own
    child generator, so ``synth_labeled_takes(k)``'s takes of an action are
    a prefix of ``synth_labeled_takes(k')``'s for k < k' under one seed.

    Returns (takes, labels), takes[i] a (T_i, 29) float32 array."""
    root = np.random.default_rng(seed)
    streams = {a: np.random.default_rng(s)
               for a, s in zip(actions, root.integers(0, 2**63, len(actions)))}
    takes: List[np.ndarray] = []
    labels: List[str] = []
    for _ in range(n_per_action):
        for action in actions:
            rng = streams[action]
            lo, hi = ACTION_BANDS[action]
            T = int(rng.integers(min_len, max_len + 1))
            t = np.arange(T, dtype=np.float32)[:, None]
            freqs = rng.uniform(lo, hi, size=(1, 4)).astype(np.float32)
            phases = rng.uniform(0, 2 * np.pi, size=(1, 4)).astype(np.float32)
            amps = rng.uniform(0.2, 1.0, size=(1, 4)).astype(np.float32)
            latent = amps * np.sin(2 * np.pi * freqs * t + phases)
            w_r = rng.normal(0, 0.6, size=(4, G1_DOF)).astype(np.float32)
            noise = 0.05 * rng.normal(0, 1, size=(T, G1_DOF)).astype(np.float32)
            takes.append((latent @ w_r + noise).astype(np.float32))
            labels.append(action)
    return takes, labels


def synthetic_npz_tree(root: str, n_files: int = 4, T: int = 200, seed: int = 0) -> str:
    """A raw npz tree shaped like the public download: a ``train_set``
    directory of files with ``joint_pos`` and ``smplx_pose_body``."""
    rng = np.random.default_rng(seed)
    train_dir = os.path.join(root, "train_set")
    os.makedirs(train_dir, exist_ok=True)
    for i in range(n_files):
        robot, human_aa = synth_pair(rng, T)
        np.savez(os.path.join(train_dir, f"motion_{i:03d}.npz"), joint_pos=robot,
                 smplx_pose_body=human_aa.reshape(T, HUMAN_JOINTS, 3))
    return root
