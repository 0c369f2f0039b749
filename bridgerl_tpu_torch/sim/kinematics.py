"""Batched forward kinematics over the G1 chain.

Counterpart of ``bridgerl_tpu/sim/kinematics.py``: (..., 29) joint radians
-> (..., 30, 3) world link positions and (..., 30, 3, 3) rotations, plain
PyTorch, differentiable, on the input's device.

The JAX package unrolls a 30-link loop into one XLA program. Run eagerly,
that loop would be several hundred small launches a call, forward and
backward. Here every link of one depth is one batch: a link's parent lies
one level up, so the 30 links take 11 levels (1, 3, 3, 3, 4, 4, 4, 2, 2, 2,
2 links), each a gather of the parents' frames and two batched products.
All 29 joint rotations come first, in one pass, from the JAX package's
expanded axis-angle formula (``_axis_angle_rot``), so the products are
those of the JAX chain: ``R_local = R_fixed @ R_joint``,
``rot_i = rot_p @ R_local``, ``pos_i = pos_p + rot_p @ origin_i``.
:func:`fk_numpy` is the independent numpy reference (Rodrigues' form).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .urdf import DEFAULT_ROOT_HEIGHT, KinematicChain


def _axis_angle_rot(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotations about unit axes (J, 3) by angles (..., J) -> (..., J, 3, 3),
    entry for entry as the JAX package's ``_axis_angle_rot``."""
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    c, s = torch.cos(angle), torch.sin(angle)
    C = 1.0 - c
    rows = [[x * x * C + c, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, z * z * C + c]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


class BatchedFK:
    """FK over one chain, level by level. The chain's arrays are moved to a
    device and dtype once, at first use there."""

    def __init__(self, chain: KinematicChain):
        parent = np.asarray(chain.parent_index, np.int64)
        act = np.asarray(chain.actuated_index, np.int64)
        depth = chain.depth()
        self.num_links = chain.num_links
        self.num_actuated = chain.num_actuated
        # levels 1, 2, ...: their links, and each link's parent's place in
        # the level above (level 0 is the root alone)
        self._levels: List[Tuple[np.ndarray, np.ndarray]] = []
        prev = np.array([0])
        for d in range(1, int(depth.max()) + 1):
            links = np.flatnonzero(depth == d)
            place = {int(l): i for i, l in enumerate(prev)}
            self._levels.append((links, np.array([place[int(parent[l])] for l in links])))
            prev = links
        order = np.concatenate([[0], *(links for links, _ in self._levels)])
        self._unorder = np.argsort(order)          # level order -> link order
        below = order[1:]                          # the non-root links, level by level
        if (act[below] < 0).any():
            raise ValueError("fixed joints below the root are not supported")
        self._arrays = {"origin_pos": chain.origin_pos[below],
                        "origin_rot": chain.origin_rot[below], "axis": chain.axis[below]}
        self._joint = act[below]                   # each one's index into q
        self._cache: Dict[Tuple, Dict[str, torch.Tensor]] = {}

    def _consts(self, device, dtype) -> Dict[str, torch.Tensor]:
        key = (str(device), dtype)
        if key not in self._cache:
            t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
            c = {k: t(v) for k, v in self._arrays.items()}
            c["parents"] = [t(parents, torch.int64) for _, parents in self._levels]
            c["unorder"] = t(self._unorder, torch.int64)
            c["joint"] = t(self._joint, torch.int64)
            self._cache[key] = c
        return self._cache[key]

    def __call__(self, q: torch.Tensor, base_pos: Optional[torch.Tensor] = None,
                 base_rot: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., A) joint positions -> (positions (..., L, 3), rotations
        (..., L, 3, 3)); the root at ``base_pos`` (default (0, 0, 0.74)) and
        ``base_rot`` (default identity)."""
        if q.shape[-1] != self.num_actuated:
            raise ValueError(f"q has {q.shape[-1]} joints; the chain has {self.num_actuated}")
        c = self._consts(q.device, q.dtype)
        lead = q.shape[:-1]
        if base_pos is None:
            base_pos = torch.tensor([0.0, 0.0, DEFAULT_ROOT_HEIGHT], dtype=q.dtype,
                                    device=q.device)
        if base_rot is None:
            base_rot = torch.eye(3, dtype=q.dtype, device=q.device)
        pos = base_pos.expand(*lead, 3)[..., None, :]             # (..., 1, 3)
        rot = base_rot.expand(*lead, 3, 3)[..., None, :, :]      # (..., 1, 3, 3)
        pos_levels, rot_levels = [pos], [rot]
        # every non-root link's local rotation at once, in level order
        r_local = torch.matmul(c["origin_rot"], _axis_angle_rot(c["axis"], q[..., c["joint"]]))
        origin = c["origin_pos"][..., None]                         # (29, 3, 1)
        start = 0
        for parents in c["parents"]:
            end = start + parents.shape[0]
            rot_p, pos_p = rot[..., parents, :, :], pos[..., parents, :]
            rot = torch.matmul(rot_p, r_local[..., start:end, :, :])
            pos = pos_p + torch.matmul(rot_p, origin[start:end])[..., 0]
            pos_levels.append(pos)
            rot_levels.append(rot)
            start = end
        return (torch.cat(pos_levels, dim=-2)[..., c["unorder"], :],
                torch.cat(rot_levels, dim=-3)[..., c["unorder"], :, :])


def make_fk(chain: KinematicChain) -> BatchedFK:
    """``fk(q, base_pos=None, base_rot=None) -> (positions, rotations)``,
    over any leading axes of q (the JAX package's takes one (29,) q and is
    vmapped)."""
    return BatchedFK(chain)


def make_batched_fk(chain: KinematicChain):
    """(N, W, A) joint windows -> (N, W, L, 3) world link positions."""
    fk = BatchedFK(chain)

    def batched_fk(q_windows: torch.Tensor) -> torch.Tensor:
        return fk(q_windows)[0]

    return batched_fk


def fk_numpy(chain: KinematicChain, q: np.ndarray,
             base_pos: Optional[np.ndarray] = None,
             base_rot: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Plain-numpy reference FK for one (A,) q, independent of the batched
    path (Rodrigues' form), in float64."""
    L = chain.num_links
    if base_pos is None:
        base_pos = np.array([0.0, 0.0, DEFAULT_ROOT_HEIGHT])
    if base_rot is None:
        base_rot = np.eye(3)
    pos = np.zeros((L, 3))
    rot = np.zeros((L, 3, 3))
    pos[0], rot[0] = base_pos, base_rot
    for i in range(1, L):
        p = chain.parent_index[i]
        R_local = chain.origin_rot[i]
        ai = chain.actuated_index[i]
        if ai >= 0:
            a = chain.axis[i]
            ang = q[ai]
            K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
            R_j = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
            R_local = R_local @ R_j
        rot[i] = rot[p] @ R_local
        pos[i] = pos[p] + rot[p] @ chain.origin_pos[i]
    return pos, rot
