"""Motion loading and fps resampling for replay.

Counterpart of ``bridgerl_tpu/sim/motion.py`` (the reference's MotionLoader,
play_g1_npy.py:79-157): a fake root at z = 0.74 with identity orientation
unless one is given, joint positions lerped from ``input_fps`` to
``output_fps``, the root quaternion slerped, finite-difference velocities.
The index pairs come from numpy; the resampling runs as a few tensor
operations on the chosen device (the card by default), the same bits on
the card as on the CPU but for the slerp's trigonometry.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data.rotations import quat_slerp
from ..device import resolve_device
from .urdf import DEFAULT_ROOT_HEIGHT


@dataclass
class Motion:
    """A resampled motion ready for replay, every array a tensor on one
    device."""

    dof_pos: torch.Tensor        # (T, A)
    dof_vel: torch.Tensor        # (T, A)
    base_pos: torch.Tensor       # (T, 3)
    base_rot: torch.Tensor       # (T, 4) wxyz
    base_lin_vel: torch.Tensor   # (T, 3)
    base_ang_vel: torch.Tensor   # (T, 3)
    fps: float

    @property
    def num_frames(self) -> int:
        return int(self.dof_pos.shape[0])


def resample_indices(input_frames: int, input_fps: float, output_fps: float):
    """Lerp index pairs and blend weights (play_g1_npy.py:115-127): output
    times are arange(0, duration, 1/output_fps) with duration =
    (T_in - 1) / input_fps."""
    duration = (input_frames - 1) / input_fps
    times = np.arange(0.0, duration, 1.0 / output_fps)
    phase = times / duration if duration > 0 else np.zeros_like(times)
    idx0 = np.floor(phase * (input_frames - 1)).astype(np.int32)
    idx1 = np.minimum(idx0 + 1, input_frames - 1)
    blend = (phase * (input_frames - 1) - idx0).astype(np.float32)
    return idx0, idx1, blend


def _gradient(x: torch.Tensor, dt: float) -> torch.Tensor:
    """``jnp.gradient`` along the frames, operation for operation: central
    differences inside, one sided at the ends, zeros for fewer than two
    frames. It divides by dt as a tensor, not through ``torch.gradient``:
    CUDA divides by a Python scalar as a product with its reciprocal, one
    ulp from the CPU's quotient."""
    if x.shape[0] < 2:
        return torch.zeros_like(x)
    h = torch.tensor(dt, dtype=x.dtype, device=x.device)
    return torch.cat([(x[1:2] - x[:1]) / h, (x[2:] - x[:-2]) * 0.5 / h,
                      (x[-1:] - x[-2:-1]) / h])


def load_motion(
    dof_pos,
    input_fps: float = 20.0,
    output_fps: float = 50.0,
    base_pos=None,
    base_rot=None,
    root_height: float = DEFAULT_ROOT_HEIGHT,
    device=None,
) -> Motion:
    """(T, A) joint trajectory -> a resampled ``Motion`` on ``device`` (the
    card unless ``"cpu"`` is asked for), with the given root (``base_pos``
    (T, 3), ``base_rot`` (T, 4) wxyz) or the fake one."""
    dev = resolve_device(device)
    dof_pos = np.asarray(dof_pos, np.float32)
    T_in = dof_pos.shape[0]
    if base_pos is None:
        base_pos = np.zeros((T_in, 3), np.float32)
        base_pos[:, 2] = root_height
    if base_rot is None:
        base_rot = np.zeros((T_in, 4), np.float32)
        base_rot[:, 0] = 1.0

    i0, i1, blend = resample_indices(T_in, input_fps, output_fps)
    i0 = torch.as_tensor(i0, dtype=torch.int64, device=dev)
    i1 = torch.as_tensor(i1, dtype=torch.int64, device=dev)
    b = torch.as_tensor(blend, device=dev)[:, None]

    def lerp(a):
        a = torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return a[i0] * (1 - b) + a[i1] * b

    dq, bpos = lerp(dof_pos), lerp(base_pos)
    br = torch.as_tensor(np.asarray(base_rot, np.float32), device=dev)
    brot = quat_slerp(br[i0], br[i1], b)

    dt = 1.0 / output_fps
    return Motion(dof_pos=dq, dof_vel=_gradient(dq, dt), base_pos=bpos, base_rot=brot,
                  base_lin_vel=_gradient(bpos, dt),
                  base_ang_vel=torch.zeros((dq.shape[0], 3), dtype=dq.dtype, device=dev),
                  fps=output_fps)
