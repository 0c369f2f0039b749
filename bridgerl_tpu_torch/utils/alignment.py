"""Motion retargeting API over a trained checkpoint.

Counterpart of ``bridgerl_tpu/utils/alignment.py`` (the reference's
``utils/alignment.py``, whose retargeter is a stub): a trained
DualMotionVQVAE ``.pth`` maps human 6D-rotation windows through
human_encoder -> shared quantizer -> robot_decoder to G1 joint windows, on
the card unless ``device="cpu"`` asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch


class MotionRetargeter:
    """Human motion windows -> robot joint windows through a trained
    checkpoint."""

    def __init__(self, ckpt_path: str, data_dir: Optional[str] = None, device=None):
        from ..export.motion_export import load_model_from_checkpoint

        self.model, self.exp = load_model_from_checkpoint(ckpt_path, device)
        self.device = next(self.model.parameters()).device
        self.window = self.exp.model.window_size
        self._stats = None
        if data_dir is not None:
            self._stats = {name: np.load(os.path.join(data_dir, f"{name}.npy"))
                           for name in ("mean", "std", "human_mean", "human_std")}

    def human_to_robot(self, human_windows: np.ndarray) -> np.ndarray:
        """(N, W, 126) human 6D windows -> (N, W, 29) G1 joint windows,
        normalised and de-normalised with the dataset stats when given."""
        x = np.asarray(human_windows, np.float32)
        if x.ndim == 2:
            x = x[None]
        if self._stats is not None:
            x = (x - self._stats["human_mean"]) / self._stats["human_std"]
        with torch.inference_mode():
            out = self.model(x_human=torch.as_tensor(x, device=self.device))
            y = out["human"]["retargeted"].float().cpu().numpy()
        if self._stats is not None:
            y = y * self._stats["std"] + self._stats["mean"]
        return y

    def robot_fk(self, q_windows: np.ndarray) -> np.ndarray:
        """(N, W, 29) joint windows -> (N, W, L, 3) G1 body positions, by the
        batched kinematics on the model's device, in float32."""
        from ..sim import load_g1_chain, make_batched_fk

        q = torch.as_tensor(np.asarray(q_windows, np.float32), device=self.device)
        with torch.inference_mode():
            return make_batched_fk(load_g1_chain())(q).cpu().numpy()


def load_and_align_data(robot_path: str, human_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load paired arrays and truncate them to equal length
    (utils/alignment.py:37-45)."""
    robot = np.load(robot_path).astype(np.float32)
    human = np.load(human_path).astype(np.float32)
    n = min(len(robot), len(human))
    return robot[:n], human[:n]
