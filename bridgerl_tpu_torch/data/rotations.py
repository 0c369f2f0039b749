"""Rotation conversions: axis-angle or quaternion poses -> matrices -> the
6D rotation representation, and quaternion slerp.

The port's own copy of ``bridgerl_tpu/data/rotations.py``. The device half
(``axis_angle_to_matrix``, ``quat_to_matrix``, ``matrix_to_6d``,
``rotation_6d_to_matrix``, ``quat_slerp``) takes tensors and runs on their
device, op for op as the JAX functions; ``compute_6d_rotation`` is the
numpy preprocessing, as there. The 6D representation keeps the first two
columns of each rotation matrix (Zhou et al. 2019).
"""

from __future__ import annotations

import numpy as np
import torch


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


def _skew(axis: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def axis_angle_to_matrix(rotvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: (..., 3) axis-angle -> (..., 3, 3), with the
    first-order I + K * angle below 1e-8 rad."""
    angle = torch.linalg.vector_norm(rotvec, dim=-1, keepdim=True)
    small = angle < 1e-8
    K = _skew(rotvec / torch.where(small, torch.ones_like(angle), angle))
    a = angle[..., None]
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device).expand(K.shape)
    R = eye + torch.sin(a) * K + (1.0 - torch.cos(a)) * (K @ K)
    return torch.where(small[..., None], eye + K * a, R)


def quat_to_matrix(quat: torch.Tensor, scalar_first: bool = False) -> torch.Tensor:
    """(..., 4) quaternion -> (..., 3, 3), normalised first. xyzw (SciPy's
    layout) by default; ``scalar_first`` for wxyz."""
    if scalar_first:
        w, x, y, z = quat.unbind(-1)
    else:
        x, y, z, w = quat.unbind(-1)
    n = torch.sqrt(w * w + x * x + y * y + z * z)
    n = torch.where(n < 1e-12, torch.ones_like(n), n)
    w, x, y, z = w / n, x / n, y / n, z / n
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def matrix_to_6d(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two columns, row by row
    ([r00, r01, r10, r11, r20, r21])."""
    return R[..., :, :2].reshape(*R.shape[:-2], 6)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt recovery of (..., 3, 3) from the (..., 6) representation."""
    m = d6.reshape(*d6.shape[:-1], 3, 2)
    a1, a2 = m[..., 0], m[..., 1]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp_min(1e-8)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.vector_norm(a2p, dim=-1, keepdim=True).clamp_min(1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between wxyz quaternions, over the
    shorter arc, broadcasting over leading axes; ``t`` in [0, 1]. Nearly
    parallel pairs (sin theta < 1e-6) are lerped. The output is normalised."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    theta = torch.arccos(torch.clamp(torch.abs(dot), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    denom = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / denom)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / denom)
    out = w0 * q0 + w1 * q1
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-12)
