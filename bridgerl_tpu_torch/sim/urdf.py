"""URDF parsing and the G1's fixed kinematic chain, as flat arrays for
batched forward kinematics.

Counterpart of ``bridgerl_tpu/sim/urdf.py``, numpy and ``xml.etree`` as
there. The chain comes from the bundled spec ``assets/g1_29dof.json``, a
copy of the JAX package's, which was extracted once from the vendor URDF
(``cli/extract_urdf_spec.py``): 30 links in topological order, the root
first, each non-root link joined to its parent by one of the 29 actuated
joints, and the vendor's collision primitives (``collisions``), which the
volumetric renderer draws. ``chain_to_urdf`` writes a chain back as URDF
text, so the extraction can be checked to round-trip.
"""

from __future__ import annotations

import functools
import json
import math
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

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

    def to_json(self) -> str:
        return json.dumps({
            "link_names": self.link_names,
            "joint_names": self.joint_names,
            "parent_index": self.parent_index.tolist(),
            "origin_pos": self.origin_pos.tolist(),
            "origin_rot": self.origin_rot.tolist(),
            "axis": self.axis.tolist(),
            "actuated_index": self.actuated_index.tolist(),
            "actuated_names": self.actuated_names,
            "lower": self.lower.tolist(),
            "upper": self.upper.tolist(),
        })

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


def matrix_to_rpy(R: np.ndarray) -> List[float]:
    """Inverse of ``rpy_to_matrix`` (R = Rz(y) @ Ry(p) @ Rx(r)); at
    |pitch| = pi / 2 the yaw is pinned to 0."""
    sp = -float(R[2, 0])
    p = math.asin(max(-1.0, min(1.0, sp)))
    if abs(sp) < 1.0 - 1e-9:
        r = math.atan2(float(R[2, 1]), float(R[2, 2]))
        y = math.atan2(float(R[1, 0]), float(R[0, 0]))
    else:
        r = math.atan2(-float(R[1, 2]), float(R[1, 1]))
        y = 0.0
    return [r, p, y]


@dataclass
class CollisionPrim:
    """One collision primitive of a link, in the link's frame. ``size``:
    sphere [radius]; cylinder [radius, length] along the frame's Z; box
    [sx, sy, sz]. The vendor G1 URDF expresses every body volume so."""

    link: str
    kind: str                  # 'sphere' | 'cylinder' | 'box'
    size: List[float]
    origin_pos: List[float]
    origin_rpy: List[float]


def _origin(el) -> tuple:
    """(xyz, rpy) of an element's ``<origin>``, zeros where absent."""
    origin = el.find("origin")
    xyz = origin.get("xyz", "0 0 0") if origin is not None else "0 0 0"
    rpy = origin.get("rpy", "0 0 0") if origin is not None else "0 0 0"
    return [float(v) for v in xyz.split()], [float(v) for v in rpy.split()]


def parse_urdf_collisions(path: str) -> List[CollisionPrim]:
    """Each link's sphere, cylinder and box collisions from a URDF; mesh
    collisions are skipped."""
    prims: List[CollisionPrim] = []
    for link in ET.parse(path).getroot().findall("link"):
        lname = link.get("name")
        for col in link.findall("collision"):
            xyz, rpy = _origin(col)
            geom = col.find("geometry")
            if geom is None:
                continue
            sphere, cyl, box = geom.find("sphere"), geom.find("cylinder"), geom.find("box")
            if sphere is not None:
                prims.append(CollisionPrim(lname, "sphere", [float(sphere.get("radius"))],
                                           xyz, rpy))
            elif cyl is not None:
                prims.append(CollisionPrim(
                    lname, "cylinder", [float(cyl.get("radius")), float(cyl.get("length"))],
                    xyz, rpy))
            elif box is not None:
                prims.append(CollisionPrim(
                    lname, "box", [float(v) for v in box.get("size").split()], xyz, rpy))
    return prims


def collisions_to_rows(prims: List[CollisionPrim]) -> List[list]:
    return [[p.link, p.kind, p.size, p.origin_pos, p.origin_rpy] for p in prims]


def collisions_from_rows(rows: List[list]) -> List[CollisionPrim]:
    return [CollisionPrim(link, kind, list(size), list(pos), list(rpy))
            for link, kind, size, pos, rpy in rows]


def collisions_equal(a: List[CollisionPrim], b: List[CollisionPrim],
                     atol: float = 1e-6) -> List[str]:
    """The differences between two collision lists, in order (empty: equal)."""
    if len(a) != len(b):
        return [f"count {len(a)} != {len(b)}"]
    diffs: List[str] = []
    for i, (pa, pb) in enumerate(zip(a, b)):
        if (pa.link, pa.kind) != (pb.link, pb.kind):
            diffs.append(f"[{i}] {pa.link}/{pa.kind} != {pb.link}/{pb.kind}")
        elif not (np.allclose(pa.size, pb.size, atol=atol)
                  and np.allclose(pa.origin_pos, pb.origin_pos, atol=atol)
                  and np.allclose(pa.origin_rpy, pb.origin_rpy, atol=atol)):
            diffs.append(f"[{i}] {pa.link}/{pa.kind} numeric diff")
    return diffs


def load_g1_collisions() -> List[CollisionPrim]:
    """The collision primitives bundled with the G1 spec."""
    with open(G1_SPEC_PATH) as f:
        return collisions_from_rows(json.load(f).get("collisions", []))


def chain_to_urdf(chain: KinematicChain, robot_name: str = "g1_spec") -> str:
    """A chain as minimal URDF text: links, and joints with their origins,
    axes and limits (no inertials, no meshes)."""
    lines = [f'<robot name="{robot_name}">']
    for name in chain.link_names:
        lines.append(f'  <link name="{name}"/>')
    for i in range(1, chain.num_links):
        ai = int(chain.actuated_index[i])
        jtype = "revolute" if ai >= 0 else "fixed"
        xyz = " ".join(repr(float(v)) for v in chain.origin_pos[i])
        rpy = " ".join(repr(float(v)) for v in matrix_to_rpy(chain.origin_rot[i]))
        parent = chain.link_names[int(chain.parent_index[i])]
        lines.append(f'  <joint name="{chain.joint_names[i]}" type="{jtype}">')
        lines.append(f'    <origin xyz="{xyz}" rpy="{rpy}"/>')
        lines.append(f'    <parent link="{parent}"/>')
        lines.append(f'    <child link="{chain.link_names[i]}"/>')
        if ai >= 0:
            axis = " ".join(repr(float(v)) for v in chain.axis[i])
            lines.append(f'    <axis xyz="{axis}"/>')
            lines.append(f'    <limit lower="{float(chain.lower[ai])!r}" '
                         f'upper="{float(chain.upper[ai])!r}"/>')
        lines.append("  </joint>")
    lines.append("</robot>")
    return "\n".join(lines)


def chains_equal(a: KinematicChain, b: KinematicChain, atol: float = 1e-5) -> List[str]:
    """The structural and numeric differences between two chains (empty:
    equal)."""
    diffs: List[str] = []
    for name in ("link_names", "joint_names", "actuated_names"):
        va, vb = getattr(a, name), getattr(b, name)
        if va != vb:
            diffs.append(f"{name}: {va} != {vb}")
    if not np.array_equal(a.parent_index, b.parent_index):
        diffs.append("parent_index differs")
    if not np.array_equal(a.actuated_index, b.actuated_index):
        diffs.append("actuated_index differs")
    for name in ("origin_pos", "origin_rot", "axis", "lower", "upper"):
        va, vb = getattr(a, name), getattr(b, name)
        if va.shape != vb.shape:
            diffs.append(f"{name}: shape {va.shape} != {vb.shape}")
        elif not np.allclose(va, vb, atol=atol):
            diffs.append(f"{name}: max |diff| = {np.abs(va - vb).max():.3e}")
    return diffs


def parse_urdf_joints(path: str) -> List[JointSpec]:
    joints: List[JointSpec] = []
    for j in ET.parse(path).getroot().findall("joint"):
        xyz, rpy = _origin(j)
        axis_el = j.find("axis")
        axis = axis_el.get("xyz", "1 0 0") if axis_el is not None else "1 0 0"
        limit = j.find("limit")
        joints.append(JointSpec(
            name=j.get("name"),
            joint_type=j.get("type", "fixed"),
            parent_link=j.find("parent").get("link"),
            child_link=j.find("child").get("link"),
            origin_xyz=xyz,
            origin_rpy=rpy,
            axis=[float(v) for v in axis.split()],
            lower=float(limit.get("lower", 0.0)) if limit is not None else 0.0,
            upper=float(limit.get("upper", 0.0)) if limit is not None else 0.0,
        ))
    return joints


def build_chain(joints: List[JointSpec], actuated_order: Optional[Sequence[str]] = None,
                root_link: Optional[str] = None, keep_fixed: bool = False) -> KinematicChain:
    """The chain in topological order (children by joint name), kept to the
    links on actuated paths: fixed leaf decorations (logo, imu, camera
    frames) are dropped unless ``keep_fixed``."""
    by_parent: Dict[str, List[JointSpec]] = {}
    for j in joints:
        by_parent.setdefault(j.parent_link, []).append(j)
    roots = sorted({j.parent_link for j in joints} - {j.child_link for j in joints})
    if root_link is None:
        if len(roots) != 1:
            raise ValueError(f"Ambiguous URDF root links: {roots}")
        root_link = roots[0]

    actuated_order = list(actuated_order) if actuated_order is not None else [
        j.name for j in joints if j.joint_type in ("revolute", "continuous", "prismatic")]
    act_idx = {n: i for i, n in enumerate(actuated_order)}
    by_name = {j.name: j for j in joints}
    for n in actuated_order:
        if n not in by_name:
            raise ValueError(f"Actuated joint {n} not in URDF")

    def subtree_has_actuated(link: str) -> bool:
        return any(j.name in act_idx or subtree_has_actuated(j.child_link)
                   for j in by_parent.get(link, []))

    link_names, joint_names, parent_index = [root_link], ["<root>"], [-1]
    origin_pos = [np.zeros(3, np.float32)]
    origin_rot = [np.eye(3, dtype=np.float32)]
    axis = [np.zeros(3, np.float32)]
    actuated_index = [-1]

    def visit(link: str, link_id: int):
        for j in sorted(by_parent.get(link, []), key=lambda x: x.name):
            if not keep_fixed and j.name not in act_idx and not subtree_has_actuated(j.child_link):
                continue
            child_id = len(link_names)
            link_names.append(j.child_link)
            joint_names.append(j.name)
            parent_index.append(link_id)
            origin_pos.append(np.asarray(j.origin_xyz, np.float32))
            origin_rot.append(rpy_to_matrix(j.origin_rpy))
            a = np.asarray(j.axis, np.float32)
            n = np.linalg.norm(a)
            axis.append(a / n if n > 0 else a)
            actuated_index.append(act_idx.get(j.name, -1))
            visit(j.child_link, child_id)

    visit(root_link, 0)
    lower = np.zeros(len(actuated_order), np.float32)
    upper = np.zeros(len(actuated_order), np.float32)
    for n, i in act_idx.items():
        lower[i], upper[i] = by_name[n].lower, by_name[n].upper
    return KinematicChain(
        link_names=link_names, joint_names=joint_names,
        parent_index=np.asarray(parent_index, np.int32), origin_pos=np.stack(origin_pos),
        origin_rot=np.stack(origin_rot), axis=np.stack(axis),
        actuated_index=np.asarray(actuated_index, np.int32),
        actuated_names=list(actuated_order), lower=lower, upper=upper)


def load_g1_chain(urdf_path: Optional[str] = None) -> KinematicChain:
    """The Unitree G1 29-DoF chain: built from ``urdf_path`` if given, else
    the bundled spec (read once; callers must not modify its arrays)."""
    if urdf_path is not None:
        return build_chain(parse_urdf_joints(urdf_path), G1_JOINT_NAMES)
    return _bundled_chain()


@functools.lru_cache(maxsize=1)
def _bundled_chain() -> KinematicChain:
    with open(G1_SPEC_PATH) as f:
        return KinematicChain.from_json(f.read())
