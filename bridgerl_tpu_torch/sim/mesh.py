"""The vendor G1's visual meshes, folded into the chain's link frames for
the mesh renderer.

Counterpart of ``bridgerl_tpu/sim/mesh.py``. The reference renders the G1's
STL meshes through Omniverse (render_viewport.py:199-201). Here the STL files
are read as data at render time (the repository carries none): every visual,
also those of fixed and finger links that the 29-DoF chain drops, is folded
into its nearest ancestor on the chain, and the set is decimated to a
budget a software renderer can draw each frame.

The vendor URDF is found through ``BRIDGERL_G1_URDF``, else at
``VENDOR_URDF_CANDIDATES`` (inside the repository); where none is found the
loaders return None and callers draw the volumetric body instead.
"""

from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .urdf import JointSpec, KinematicChain, parse_urdf_joints, rpy_to_matrix

# candidate vendor URDFs, the first that exists wins
VENDOR_URDF_CANDIDATES = (
    str(Path(__file__).resolve().parents[2] / "assets" / "g1_local" / "urdf" / "g1"
        / "main.urdf"),
)


def find_vendor_urdf() -> Optional[str]:
    env = os.environ.get("BRIDGERL_G1_URDF")
    if env:
        return env if os.path.exists(env) else None
    for cand in VENDOR_URDF_CANDIDATES:
        if os.path.exists(cand):
            return cand
    return None


def load_stl(path: str) -> np.ndarray:
    """An STL file -> (T, 3, 3) float32 triangle vertices. Binary when the
    size is 84 + 50 n bytes (the vendor files say 'solid' in their header
    all the same), else ASCII."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(84)
        if len(head) == 84:
            (n,) = struct.unpack("<I", head[80:84])
            if size == 84 + 50 * n:
                # a record: normal (3 f32), three vertices (9 f32), attribute (u16)
                rec = np.frombuffer(f.read(50 * n), dtype=np.uint8).reshape(n, 50)
                tri = rec[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
                return np.ascontiguousarray(tri, dtype=np.float32)
    verts: List[List[float]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if parts[:1] == ["vertex"]:
                verts.append([float(x) for x in parts[1:4]])
    return np.asarray(verts, np.float32).reshape(-1, 3, 3)


def decimate(tris: np.ndarray, target_faces: int) -> np.ndarray:
    """Vertex-clustering decimation to at most ``target_faces`` triangles:
    vertices snap to a grid cell's centroid and degenerate triangles go;
    the cell grows by 1.4x until the budget holds. Deterministic."""
    if tris.shape[0] <= target_faces:
        return tris
    v = tris.reshape(-1, 3)
    lo = v.min(axis=0)
    diag = float(np.linalg.norm(v.max(axis=0) - lo))
    if diag == 0.0:
        return tris[:target_faces]
    cell = diag / 96.0
    for _ in range(24):
        q = np.floor((v - lo) / cell).astype(np.int64)
        key = (q[:, 0] * 73856093) ^ (q[:, 1] * 19349663) ^ (q[:, 2] * 83492791)
        uniq, inverse = np.unique(key, return_inverse=True)
        cnt = np.bincount(inverse, minlength=uniq.shape[0]).astype(np.float64)
        rep = np.stack([np.bincount(inverse, weights=v[:, d], minlength=uniq.shape[0]) / cnt
                        for d in range(3)], axis=1)
        fidx = inverse.reshape(-1, 3)
        keep = ((fidx[:, 0] != fidx[:, 1]) & (fidx[:, 1] != fidx[:, 2])
                & (fidx[:, 0] != fidx[:, 2]))
        if int(keep.sum()) <= target_faces:
            return rep[fidx[keep]].astype(np.float32)
        cell *= 1.4
    return rep[fidx[keep]][:target_faces].astype(np.float32)


@dataclass
class LinkMesh:
    """Decimated visual triangles in the frame of a link on the chain."""

    link: str
    tris: np.ndarray          # (T, 3, 3) float32
    color: Tuple[float, float, float]


def _compose(R1, t1, R2, t2):
    """(R1, t1) after (R2, t2)."""
    return R1 @ R2, R1 @ t2 + t1


def parse_urdf_visual_entries(urdf_path: str):
    """[(link, mesh path, origin xyz, origin rpy, rgb)] of every mesh
    ``<visual>`` in a URDF, the paths resolved against its directory."""
    base = os.path.dirname(urdf_path)
    out = []
    for link in ET.parse(urdf_path).getroot().iter("link"):
        for vis in link.findall("visual"):
            geom = vis.find("geometry")
            mesh = geom.find("mesh") if geom is not None else None
            if mesh is None:
                continue
            origin = vis.find("origin")
            xyz = [float(x) for x in (origin.get("xyz", "0 0 0") if origin is not None
                                      else "0 0 0").split()]
            rpy = [float(x) for x in (origin.get("rpy", "0 0 0") if origin is not None
                                      else "0 0 0").split()]
            color = (0.55, 0.55, 0.58)
            mat = vis.find("material")
            if mat is not None and mat.find("color") is not None:
                color = tuple(float(x) for x in mat.find("color").get("rgba").split()[:3])
            out.append((link.get("name"), os.path.normpath(os.path.join(base, mesh.get("filename"))),
                        xyz, rpy, color))
    return out


def _paths_to_chain(joints: List[JointSpec], chain: KinematicChain):
    """link name -> (chain link, R, t): the joints off the chain (fixed, or
    finger joints at angle 0) composed up to the nearest ancestor on it;
    None for a link with no such ancestor."""
    on_chain = set(chain.link_names)
    by_child: Dict[str, JointSpec] = {j.child_link: j for j in joints}
    cache: Dict[str, Optional[Tuple[str, np.ndarray, np.ndarray]]] = {}

    def resolve(link: str):
        if link in on_chain:
            return link, np.eye(3), np.zeros(3)
        if link not in cache:
            j = by_child.get(link)
            up = resolve(j.parent_link) if j is not None else None
            if up is None:
                cache[link] = None
            else:
                anchor, R_up, t_up = up
                R, t = _compose(R_up, t_up, rpy_to_matrix(j.origin_rpy),
                                np.asarray(j.origin_xyz, np.float64))
                cache[link] = (anchor, R, t)
        return cache[link]

    return resolve


def load_link_meshes(chain: KinematicChain, urdf_path: Optional[str] = None,
                     total_budget: int = 24000) -> Optional[List[LinkMesh]]:
    """Every visual mesh, decimated (each to its share of ``total_budget``,
    at least 200) and expressed in its chain link's frame; None where no
    vendor URDF or none of its meshes is found."""
    urdf_path = urdf_path or find_vendor_urdf()
    if urdf_path is None or not os.path.exists(urdf_path):
        return None
    entries = [e for e in parse_urdf_visual_entries(urdf_path) if os.path.exists(e[1])]
    if not entries:
        return None
    resolve = _paths_to_chain(parse_urdf_joints(urdf_path), chain)
    raw = []
    for lname, fname, xyz, rpy, color in entries:
        anchor = resolve(lname)
        if anchor is not None:
            raw.append((anchor, xyz, rpy, color, load_stl(fname)))
    if not raw:
        return None
    total = float(sum(r[-1].shape[0] for r in raw))
    out: List[LinkMesh] = []
    for (link, R_a, t_a), xyz, rpy, color, tris in raw:
        tris = decimate(tris, max(200, int(total_budget * tris.shape[0] / total)))
        R, t = _compose(R_a, t_a, rpy_to_matrix(rpy), np.asarray(xyz, np.float64))
        world = np.einsum("ij,tnj->tni", R, tris.astype(np.float64)) + t
        out.append(LinkMesh(link=link, tris=world.astype(np.float32), color=color))
    return out


_MESH_CACHE: Dict[Tuple[str, int], Optional[List[LinkMesh]]] = {}


def load_g1_meshes(chain: KinematicChain,
                   total_budget: int = 24000) -> Optional[List[LinkMesh]]:
    """``load_link_meshes`` of the vendor URDF, cached by its path and budget."""
    urdf = find_vendor_urdf()
    key = (urdf or "", total_budget)
    if key not in _MESH_CACHE:
        _MESH_CACHE[key] = load_link_meshes(chain, urdf, total_budget)
    return _MESH_CACHE[key]
