"""The G1's fixed kinematic chain, as flat arrays for batched forward
kinematics.

Counterpart of the chain half of ``bridgerl_tpu/sim/urdf.py``
(``JointSpec``, ``KinematicChain``, ``rpy_to_matrix``,
``DEFAULT_ROOT_HEIGHT``, ``load_g1_chain``). The chain comes from the
bundled spec ``assets/g1_29dof.json``, a copy of the JAX package's, which
was extracted once from the vendor URDF: 30 links in topological order, the
root first, each non-root link joined to its parent by one of the 29
actuated joints. Parsing a URDF is not ported.
"""

from __future__ import annotations

import functools
import json
import math
import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

# The 29 actuated joints in the order of the model's 29-dim joint vectors
# (the reference's play_g1_npy.py:170-180).
G1_JOINT_NAMES: List[str] = [
    "left_hip_pitch_joint", "left_hip_roll_joint", "left_hip_yaw_joint",
    "left_knee_joint", "left_ankle_pitch_joint", "left_ankle_roll_joint",
    "right_hip_pitch_joint", "right_hip_roll_joint", "right_hip_yaw_joint",
    "right_knee_joint", "right_ankle_pitch_joint", "right_ankle_roll_joint",
    "waist_yaw_joint", "waist_roll_joint", "waist_pitch_joint",
    "left_shoulder_pitch_joint", "left_shoulder_roll_joint", "left_shoulder_yaw_joint",
    "left_elbow_joint", "left_wrist_roll_joint", "left_wrist_pitch_joint", "left_wrist_yaw_joint",
    "right_shoulder_pitch_joint", "right_shoulder_roll_joint", "right_shoulder_yaw_joint",
    "right_elbow_joint", "right_wrist_roll_joint", "right_wrist_pitch_joint",
    "right_wrist_yaw_joint",
]

DEFAULT_ROOT_HEIGHT = 0.74  # the replay's root z (play_g1_npy.py:103)
G1_SPEC_PATH = os.path.join(os.path.dirname(__file__), "assets", "g1_29dof.json")


@dataclass
class JointSpec:
    name: str
    joint_type: str            # 'revolute' | 'fixed' | 'prismatic' | 'continuous'
    parent_link: str
    child_link: str
    origin_xyz: List[float]
    origin_rpy: List[float]
    axis: List[float]
    lower: float = 0.0
    upper: float = 0.0


@dataclass
class KinematicChain:
    """A tree in topological order. Link 0 is the root; for link i > 0,
    joint i - 1 joins parent_index[i] to i."""

    link_names: List[str]
    joint_names: List[str]                 # per non-root link, the incoming joint
    parent_index: np.ndarray               # (L,) int32, parent_index[0] == -1
    origin_pos: np.ndarray                 # (L, 3) fixed translation (root row zero)
    origin_rot: np.ndarray                 # (L, 3, 3) fixed rotation (root row eye)
    axis: np.ndarray                       # (L, 3) joint axis (zero for fixed/root)
    actuated_index: np.ndarray             # (L,) int32 index into q, -1 if fixed
    actuated_names: List[str]              # the order of q
    lower: np.ndarray                      # (A,) joint limits in q's order
    upper: np.ndarray

    @property
    def num_links(self) -> int:
        return len(self.link_names)

    @property
    def num_actuated(self) -> int:
        return len(self.actuated_names)

    def depth(self) -> np.ndarray:
        """(L,) each link's number of joints from the root."""
        d = np.zeros(self.num_links, np.int64)
        for i in range(1, self.num_links):
            d[i] = d[self.parent_index[i]] + 1
        return d

    @classmethod
    def from_json(cls, s: str) -> "KinematicChain":
        d = json.loads(s)
        return cls(
            link_names=d["link_names"],
            joint_names=d["joint_names"],
            parent_index=np.asarray(d["parent_index"], np.int32),
            origin_pos=np.asarray(d["origin_pos"], np.float32),
            origin_rot=np.asarray(d["origin_rot"], np.float32),
            axis=np.asarray(d["axis"], np.float32),
            actuated_index=np.asarray(d["actuated_index"], np.int32),
            actuated_names=d["actuated_names"],
            lower=np.asarray(d["lower"], np.float32),
            upper=np.asarray(d["upper"], np.float32),
        )


def rpy_to_matrix(rpy: Sequence[float]) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw -> rotation matrix (R = Rz @ Ry @ Rx)."""
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


@functools.lru_cache(maxsize=1)
def load_g1_chain() -> KinematicChain:
    """The Unitree G1 29-DoF chain from the bundled spec (read once; callers
    must not modify its arrays)."""
    with open(G1_SPEC_PATH) as f:
        return KinematicChain.from_json(f.read())
