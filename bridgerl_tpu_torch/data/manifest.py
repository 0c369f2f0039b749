"""Checksum and schema manifest for the raw paired-motion npz tree.

The port's own copy of ``bridgerl_tpu/data/manifest.py``. The reference
fetches its dataset with no integrity or schema check
(scripts/data/download_data.py:12-16), and its preprocessing dispatches on
``dim % 3 == 0`` first (process_data.py:16-21), which would misparse a
21-joint quaternion stream (21 * 4 = 84 is also divisible by 3). This gates
both before training sees the data:

- schema: ``joint_pos`` must be (T, 29) float and ``smplx_pose_body``
  (T, 21, 3) or (T, 63) axis-angle, of the same T; anything else is an
  error, not a guess, and an entry that needs pickle is rejected unread;
- sha256 manifest (``MANIFEST.json`` at the tree's root): the first verified
  run records the checksums, later runs enforce them and record new files,
  and a file recorded but gone is an error.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

MANIFEST_NAME = "MANIFEST.json"

# the public dataset's coordinates (download_data.py:12-16)
DATASET = {
    "id": "seulzx/smplx_datasets",
    "repo_type": "dataset",
    "keys": ("joint_pos", "smplx_pose_body"),
    "robot_dof": 29,
    "human_joints": 21,
}

G1_DOF = DATASET["robot_dof"]
HUMAN_JOINTS = DATASET["human_joints"]


@dataclass
class VerifyReport:
    ok: bool = True
    checked: int = 0
    recorded: int = 0
    errors: List[str] = field(default_factory=list)

    def summary(self) -> str:
        status = "OK" if self.ok else "FAILED"
        return (f"verify {status}: {self.checked} file(s) checked, "
                f"{self.recorded} checksum(s) recorded, {len(self.errors)} error(s)")


def candidate_files(root: str) -> List[str]:
    """Every raw npz under the tree, in a fixed order."""
    return sorted(glob.glob(os.path.join(root, "**", "*.npz"), recursive=True))


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _check_schema(path: str, errors: List[str]) -> None:
    # allow_pickle=False: the tree is downloaded content and the schema
    # admits plain float arrays only; np.load raises on a pickled entry
    with np.load(path, allow_pickle=False) as data:
        for key in DATASET["keys"]:
            if key not in data:
                errors.append(f"{path}: missing key {key!r}")
                return
        jp = np.asarray(data["joint_pos"])
        if jp.ndim != 2 or jp.shape[1] != G1_DOF:
            errors.append(f"{path}: joint_pos shape {jp.shape} != (T, {G1_DOF})")
        body = np.asarray(data["smplx_pose_body"])
        flat = int(np.prod(body.shape[1:])) if body.ndim >= 2 else -1
        aa_ok = ((body.ndim == 3 and body.shape[1:] == (HUMAN_JOINTS, 3))
                 or (body.ndim == 2 and flat == HUMAN_JOINTS * 3))
        if not aa_ok:
            errors.append(
                f"{path}: smplx_pose_body shape {body.shape} is not axis-angle "
                f"(T, {HUMAN_JOINTS}, 3) / (T, {HUMAN_JOINTS * 3}) — quaternion or unknown "
                f"layouts are rejected (the %3-first dispatch would misparse them)")
        if len(jp) != len(body):
            errors.append(f"{path}: joint_pos T={len(jp)} != smplx_pose_body T={len(body)}")


def verify_tree(root: str) -> VerifyReport:
    """Schema-check every npz under ``root`` and record or enforce its
    checksum. The manifest is written only when everything passed, so a
    failing tree never overwrites known-good checksums."""
    report = VerifyReport()
    files = candidate_files(root)
    if not files:
        report.ok = False
        report.errors.append(f"no npz files under {root}")
        return report

    manifest_path = os.path.join(root, MANIFEST_NAME)
    known: Dict[str, str] = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            known = json.load(f)

    updated = dict(known)
    present = set()
    for path in files:
        rel = os.path.relpath(path, root)
        present.add(rel)
        report.checked += 1
        try:
            _check_schema(path, report.errors)
        except (ValueError, OSError) as e:
            report.errors.append(f"{rel}: unreadable without pickle ({e})")
        digest = _sha256(path)
        if rel in known:
            if known[rel] != digest:
                report.errors.append(f"{rel}: checksum mismatch")
        else:
            updated[rel] = digest
            report.recorded += 1

    for rel in sorted(set(known) - present):
        report.errors.append(f"{rel}: in manifest but missing from tree")

    report.ok = not report.errors
    if report.ok and updated != known:
        with open(manifest_path, "w") as f:
            json.dump(updated, f, indent=1, sort_keys=True)
    return report
