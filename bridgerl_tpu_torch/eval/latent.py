"""Latent-space analysis: encoder embeddings -> t-SNE maps of domain
alignment and of actions.

Counterpart of ``bridgerl_tpu/eval/latent.py`` (the reference's
analyze_latent_space.py):
- raw npz pairs grouped by an action keyword in the file name (walk, run,
  jump, dance, fight, sprint, fall), human poses to 6D, normalised with the
  given stats, windowed at 50% overlap, at most 300 windows an action;
- both encoders run without gradients on the model's device (K1's forward
  on the card for a transformer tower); a single token is squeezed, more
  are flattened (conv towers);
- t-SNE (perplexity 30, PCA init) over the robot and human latents
  together, and two scatter plots: robot against human, and the robot's by
  action.

scikit-learn's TSNE and matplotlib are imported by ``analyze_checkpoint``
before it encodes anything, never with this module.
"""

from __future__ import annotations

import glob
import zipfile
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data.pipeline import slice_windows
from ..data.rotations import compute_6d_rotation
from ..export.motion_export import load_model_from_checkpoint
from ..utils.optional import pyplot, require

ACTION_KEYWORDS = ("walk", "run", "jump", "dance", "fight", "sprint", "fall")


def load_paired_data_by_action(raw_dir: str, window: int, stats: Dict[str, np.ndarray],
                               max_per_action: int = 300
                               ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """action -> (robot (n, W, 29), human (n, W, 126)) windows of the raw
    npz files whose names hold the keyword (analyze_latent_space.py:62-127);
    files without both arrays, or that fail to load, are skipped."""
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    files = sorted(glob.glob(os.path.join(raw_dir, "**", "*.npz"), recursive=True))
    for action in ACTION_KEYWORDS:
        r_wins: List[np.ndarray] = []
        h_wins: List[np.ndarray] = []
        for f in files:
            if action not in os.path.basename(f).lower():
                continue
            try:
                data = np.load(f, allow_pickle=True)
                if "joint_pos" not in data or "smplx_pose_body" not in data:
                    continue
                robot = np.asarray(data["joint_pos"], np.float32)
                if robot.ndim > 2:
                    robot = robot.reshape(robot.shape[0], -1)
                human = compute_6d_rotation(np.asarray(data["smplx_pose_body"])).astype(np.float32)
                n = min(len(robot), len(human))
                robot = (robot[:n] - stats["mean"]) / stats["std"]
                human = (human[:n] - stats["human_mean"]) / stats["human_std"]
                stride = max(1, window // 2)
                r_wins.append(slice_windows(robot, window, stride))
                h_wins.append(slice_windows(human, window, stride))
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                continue
        if r_wins:
            r = np.concatenate(r_wins)[:max_per_action]
            h = np.concatenate(h_wins)[:max_per_action]
            if len(r):
                out[action] = (r, h)
    return out


@torch.no_grad()
def get_latent_vectors(model, x: np.ndarray, side: str, batch: int = 256) -> np.ndarray:
    """The ``side`` ("robot" or "human") encoder's latents of (n, W, D)
    windows, ``batch`` at a time on the model's device: (n, D) for one
    token a window, else (n, tokens * D) (analyze_latent_space.py:149-157)."""
    encode = model.encode_robot if side == "robot" else model.encode_human
    device = next(model.parameters()).device
    outs = []
    for i in range(0, len(x), batch):
        z = encode(torch.as_tensor(np.asarray(x[i:i + batch], np.float32), device=device))
        z = z.float().cpu().numpy()
        outs.append(z[:, 0, :] if z.shape[1] == 1 else z.reshape(z.shape[0], -1))
    return np.concatenate(outs)


def analyze_checkpoint(ckpt_path: str, raw_dir: str, data_dir: str = "data/processed",
                       out_dir: str = "plots/latent_space", max_per_action: int = 300,
                       tsne_perplexity: float = 30.0, seed: int = 0,
                       ref_normalize: bool = False, device=None) -> List[str]:
    """The two t-SNE plots of a ``.pth`` checkpoint's latents on the raw
    takes under ``raw_dir``; the paths written (none where no take matches).
    The model runs on ``device`` (the card unless ``"cpu"``). Windows are
    encoded raw, as the models train, unless ``ref_normalize`` applies the
    saved stats first as the reference does (analyze_latent_space.py:99-100)."""
    TSNE = require("sklearn.manifold", "the latent t-SNE").TSNE
    plt = pyplot("the latent plots")
    model, exp = load_model_from_checkpoint(ckpt_path, device=device)
    if ref_normalize:
        stats = {k: np.load(os.path.join(data_dir, f"{k}.npy"))
                 for k in ("mean", "std", "human_mean", "human_std")}
    else:
        stats = {"mean": 0.0, "std": 1.0, "human_mean": 0.0, "human_std": 1.0}
    by_action = load_paired_data_by_action(raw_dir, exp.model.window_size, stats,
                                           max_per_action)
    if not by_action:
        return []

    z_r_all, z_h_all, labels = [], [], []
    for action, (r, h) in by_action.items():
        z_r_all.append(get_latent_vectors(model, r, "robot"))
        z_h_all.append(get_latent_vectors(model, h, "human"))
        labels.extend([action] * len(r))
    z_r, z_h = np.concatenate(z_r_all), np.concatenate(z_h_all)

    both = np.concatenate([z_r, z_h])
    perp = min(tsne_perplexity, max(2.0, (len(both) - 1) / 3.0))
    emb = TSNE(n_components=2, perplexity=perp, init="pca", random_state=seed).fit_transform(both)
    e_r, e_h = emb[:len(z_r)], emb[len(z_r):]

    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(ckpt_path))[0]
    written = []

    # domain alignment: robot blue circles, human red crosses (analyze:274-290)
    plt.figure(figsize=(8, 8))
    plt.scatter(e_r[:, 0], e_r[:, 1], c="blue", marker="o", s=12, alpha=0.5, label="Robot z_e")
    plt.scatter(e_h[:, 0], e_h[:, 1], c="red", marker="x", s=12, alpha=0.5, label="Human z_e")
    plt.legend()
    plt.title(f"Latent Domain Alignment: {stem}")
    p = os.path.join(out_dir, f"{stem}_domain.png")
    plt.savefig(p, dpi=150, bbox_inches="tight")
    plt.close()
    written.append(p)

    # the robot latents by action (analyze:293-311)
    plt.figure(figsize=(8, 8))
    cmap = plt.get_cmap("tab10")
    labels_arr = np.asarray(labels)
    for i, action in enumerate(sorted(set(labels))):
        m = labels_arr == action
        plt.scatter(e_r[m, 0], e_r[m, 1], color=cmap(i % 10), s=12, alpha=0.6, label=action)
    plt.legend()
    plt.title(f"Latent Action Distribution: {stem}")
    p = os.path.join(out_dir, f"{stem}_actions.png")
    plt.savefig(p, dpi=150, bbox_inches="tight")
    plt.close()
    written.append(p)
    return written
