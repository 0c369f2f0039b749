"""Rotation conversion for preprocessing: axis-angle or quaternion poses ->
the 6D rotation representation.

The port's own copy of ``compute_6d_rotation`` from
``bridgerl_tpu/data/rotations.py``, pure numpy as there (that module's
device half waits for the sim). The 6D representation keeps the first two
columns of each rotation matrix (Zhou et al. 2019).
"""

from __future__ import annotations

import numpy as np


def compute_6d_rotation(data: np.ndarray) -> np.ndarray:
    """A (T, F) pose sequence -> (T, J * 6) float32 6D rotations. Each frame's
    features are J axis-angle triplets if F divides by 3 (Rodrigues, with
    I + K * angle below 1e-8 rad), else J xyzw quaternions if F divides by 4
    (normalised; SciPy's layout). Computed in float64."""
    data = np.asarray(data, dtype=np.float64)
    T = data.shape[0]
    total = data.size // T
    flat = data.reshape(T, total)
    if total % 3 == 0:
        J = total // 3
        v = flat.reshape(T * J, 3)
        angle = np.linalg.norm(v, axis=-1, keepdims=True)
        small = angle < 1e-8
        axis = v / np.where(small, 1.0, angle)
        x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
        zero = np.zeros_like(x)
        K = np.stack([
            np.stack([zero, -z, y], -1),
            np.stack([z, zero, -x], -1),
            np.stack([-y, x, zero], -1),
        ], axis=-2)
        a = angle[..., None]
        eye = np.broadcast_to(np.eye(3), K.shape)
        R = eye + np.sin(a) * K + (1.0 - np.cos(a)) * (K @ K)
        R = np.where(small[..., None], eye + K * a, R)
    elif total % 4 == 0:
        J = total // 4
        q = flat.reshape(T * J, 4)
        n = np.linalg.norm(q, axis=-1, keepdims=True)
        q = q / np.where(n < 1e-12, 1.0, n)
        x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        R = np.stack([
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ], axis=-2)
    else:
        raise ValueError(f"Unsupported per-frame feature dim: {total}")
    d6 = R[:, :, :2].reshape(T * J, 6)   # first two columns
    return d6.reshape(T, J * 6).astype(np.float32)
