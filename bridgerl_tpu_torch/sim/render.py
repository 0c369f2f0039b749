"""Offline renderer of replayed frames: PNG, GIF or MP4.

Counterpart of ``bridgerl_tpu/sim/render.py``, which replaces the
reference's Isaac viewport and video renders (render_viewport.py,
render_video.py, debug_camera_views.py) with a matplotlib 3D renderer: line
segments between parent and child links, the collision primitives at their
links' world poses (volumetric), or the vendor visual meshes. matplotlib (on
the Agg backend) and imageio are imported when a function needs them, not
with this module; where they are missing the call raises naming the package.
Positions and rotations may be tensors on any device: they become numpy
arrays here.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ..utils.optional import imageio, pyplot, require
from .mesh import load_g1_meshes
from .urdf import CollisionPrim, KinematicChain, load_g1_collisions, rpy_to_matrix

# preset cameras (elev, azim), as debug_camera_views.py:189-202; the zero
# pose faces +x, so the front camera sits on the +x axis
CAMERA_VIEWS = {
    "front": (10, 0),
    "side": (10, -90),
    "back": (10, 180),
    "far": (25, -45),
}


def host(x) -> Optional[np.ndarray]:
    """A tensor on any device, or an array, as a numpy array (None stays)."""
    if x is None:
        return None
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def skeleton_segments(chain: KinematicChain, positions) -> np.ndarray:
    """(L, 3) link positions -> (L-1, 2, 3) parent -> child segments."""
    positions = host(positions)
    return np.asarray([[positions[chain.parent_index[i]], positions[i]]
                       for i in range(1, chain.num_links)])


def _prim_local_grid(prim: CollisionPrim, n: int = 10) -> np.ndarray:
    """A primitive's (3, n, m) surface grid in its own frame. Cylinders run
    along Z; a box is one closed band of its side faces with the top and
    bottom rows collapsed onto the axis, so one surface draws it."""
    if prim.kind == "sphere":
        (r,) = prim.size
        u = np.linspace(0.0, 2 * np.pi, 2 * n)
        v = np.linspace(0.0, np.pi, n)
        return np.stack([r * np.outer(np.cos(u), np.sin(v)),
                         r * np.outer(np.sin(u), np.sin(v)),
                         r * np.outer(np.ones_like(u), np.cos(v))])
    if prim.kind == "cylinder":
        r, length = prim.size
        u = np.linspace(0.0, 2 * np.pi, 2 * n)
        # closed profile: bottom centre, bottom rim, top rim, top centre
        prof_r = np.array([0.0, r, r, 0.0])
        prof_z = np.array([-length / 2, -length / 2, length / 2, length / 2])
        return np.stack([np.outer(np.cos(u), prof_r),
                         np.outer(np.sin(u), prof_r),
                         np.outer(np.ones_like(u), prof_z)])
    if prim.kind == "box":
        sx, sy, sz = prim.size
        px = np.array([1, 1, -1, -1, 1]) * (sx / 2)
        py = np.array([1, -1, -1, 1, 1]) * (sy / 2)
        zs = np.array([-sz / 2, -sz / 2, sz / 2, sz / 2])
        shrink = np.array([0.0, 1.0, 1.0, 0.0])
        return np.stack([np.outer(px, shrink),
                         np.outer(py, shrink),
                         np.broadcast_to(zs, (5, 4)).copy()])
    raise ValueError(f"unknown collision primitive kind {prim.kind!r}")


def draw_volumetric(ax, chain: KinematicChain, positions, rotations,
                    collisions: List[CollisionPrim], color: str = "tab:blue",
                    alpha: float = 0.95) -> int:
    """Draw the collision volumes at the (L, 3) / (L, 3, 3) world link
    poses; primitives of links off the chain are skipped. Returns how many
    were drawn."""
    positions, rotations = host(positions), host(rotations)
    by_link = {name: i for i, name in enumerate(chain.link_names)}
    drawn = 0
    for prim in collisions:
        li = by_link.get(prim.link)
        if li is None:
            continue
        R = rotations[li] @ rpy_to_matrix(prim.origin_rpy)
        t = positions[li] + rotations[li] @ np.asarray(prim.origin_pos)
        world = np.einsum("ij,jnm->inm", R, _prim_local_grid(prim)) + t[:, None, None]
        ax.plot_surface(world[0], world[1], world[2], color=color, alpha=alpha,
                        linewidth=0, antialiased=False, shade=True)
        drawn += 1
    return drawn


def draw_meshes(ax, chain: KinematicChain, positions, rotations, meshes,
                light=(0.4, -0.25, 0.88), alpha: float = 1.0) -> int:
    """Draw the visual meshes (``sim/mesh.py``'s ``LinkMesh`` list) at the
    world link poses with flat two-sided Lambert shading, every triangle in
    one ``Poly3DCollection`` so its depth sort resolves occlusion across
    links. Returns the number of triangles."""
    art3d = require("mpl_toolkits.mplot3d.art3d", "mesh rendering")
    positions, rotations = host(positions), host(rotations)
    by_link = {name: i for i, name in enumerate(chain.link_names)}
    polys, colors = [], []
    lv = np.asarray(light, np.float64)
    lv = lv / np.linalg.norm(lv)
    for lm in meshes:
        li = by_link.get(lm.link)
        if li is None:
            continue
        world = np.einsum("ij,tnj->tni", rotations[li], lm.tris.astype(np.float64)) + positions[li]
        n = np.cross(world[:, 1] - world[:, 0], world[:, 2] - world[:, 0])
        n = n / np.clip(np.linalg.norm(n, axis=1, keepdims=True), 1e-12, None)
        shade = 0.35 + 0.65 * np.abs(n @ lv)   # ambient + diffuse
        polys.append(world)
        colors.append(np.clip(shade[:, None] * np.asarray(lm.color, np.float64), 0.0, 1.0))
    if not polys:
        return 0
    faces = np.concatenate(polys)
    rgba = np.concatenate([np.concatenate(colors), np.full((faces.shape[0], 1), alpha)], axis=1)
    ax.add_collection3d(art3d.Poly3DCollection(faces, facecolors=rgba, linewidths=0,
                                               shade=False, zsort="average"))
    return faces.shape[0]


def render_frame(chain: KinematicChain, positions, out_path: Optional[str] = None,
                 view: str = "front", lim: Optional[float] = None, title: str = "",
                 rotations=None, collisions: Optional[List[CollisionPrim]] = None,
                 meshes=None):
    """One frame: the meshes, else the collision volumes (both need
    ``rotations``), else the line skeleton. Written to ``out_path`` (returned)
    or returned as an (H, W, 3) uint8 array."""
    plt = pyplot("rendering")
    art3d = require("mpl_toolkits.mplot3d.art3d", "rendering")
    positions, rotations = host(positions), host(rotations)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    if meshes is not None and rotations is not None:
        draw_meshes(ax, chain, positions, rotations, meshes)
    elif collisions is not None and rotations is not None:
        draw_volumetric(ax, chain, positions, rotations, collisions)
    else:
        ax.add_collection3d(art3d.Line3DCollection(skeleton_segments(chain, positions),
                                                   colors="tab:blue", linewidths=2))
        ax.scatter(positions[:, 0], positions[:, 1], positions[:, 2], c="tab:red", s=8)
    # a cube around the body's centroid, with a margin
    center = positions.mean(axis=0)
    extent = float(np.abs(positions - center).max())
    r = max(extent * 1.25, 0.3) if lim is None else lim
    ax.set_xlim(center[0] - r, center[0] + r)
    ax.set_ylim(center[1] - r, center[1] + r)
    ax.set_zlim(max(center[2] - r, 0.0), center[2] + r)
    ax.set_box_aspect((1, 1, 1))
    elev, azim = CAMERA_VIEWS.get(view, CAMERA_VIEWS["front"])
    ax.view_init(elev=elev, azim=azim)
    if title:
        ax.set_title(title)
    ax.set_axis_off()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return out_path
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def render_motion(chain: KinematicChain, trajectory, out_path: str, fps: int = 25,
                  max_frames: int = 200, view: str = "front", rotations=None,
                  collisions: Optional[List[CollisionPrim]] = None, meshes=None) -> str:
    """A (T, L, 3) trajectory (``G1ReplayScene.rollout``; with (T, L, 3, 3)
    ``rotations`` for volumes or meshes) to a GIF, or an MP4 by extension
    (a GIF where imageio has no ffmpeg), at most ``max_frames`` frames at
    one fixed framing (render_viewport.py:210-218, render_video.py:152-159)."""
    iio = imageio("writing a video")
    trajectory, rotations = host(trajectory), host(rotations)
    T = trajectory.shape[0]
    stride = max(1, T // max_frames)
    flat = trajectory.reshape(-1, 3)
    lim = max(float(np.abs(flat - flat.mean(0)).max()) * 1.15, 0.3)
    frames = [render_frame(chain, trajectory[t], None, view=view, lim=lim,
                           rotations=rotations[t] if rotations is not None else None,
                           collisions=collisions, meshes=meshes)
              for t in range(0, T, stride)]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if out_path.endswith(".gif"):
        iio.mimsave(out_path, frames, duration=1000.0 / fps)   # ms a frame
    else:
        try:
            iio.mimsave(out_path, frames, fps=fps)
        except (ValueError, RuntimeError):
            # no ffmpeg backend: write a GIF instead
            out_path = os.path.splitext(out_path)[0] + ".gif"
            iio.mimsave(out_path, frames, duration=1000.0 / fps)
    return out_path


def debug_camera_views(chain: KinematicChain, positions, out_dir: str,
                       views: Sequence[str] = ("front", "side", "back", "far")) -> List[str]:
    """One pose from each preset camera (debug_camera_views.py:84-202)."""
    return [render_frame(chain, positions, os.path.join(out_dir, f"view_{v}.png"), view=v,
                         title=v) for v in views]


def render_scene(scene, out_path: str, fps: int, volumetric: bool = False, mesh: bool = False,
                 **kw) -> str:
    """``render_motion`` of a ``G1ReplayScene``'s loaded motion: the vendor
    meshes (``mesh``; the collision volumes where none are found), the
    collision volumes (``volumetric``) or the line skeleton. ``kw`` goes to
    ``render_motion``."""
    chain = scene.chain
    collisions = meshes = None
    if mesh:
        meshes = load_g1_meshes(chain)
        if not meshes:
            print("[WARN] vendor STL meshes unreachable; falling back to --volumetric")
            meshes, volumetric = None, True
    if volumetric and meshes is None:
        collisions = load_g1_collisions() or None
        if collisions is None:
            print("[WARN] no collision primitives in the bundled spec; rendering skeleton")
    traj, rotations = scene.rollout_full()
    if meshes is None and collisions is None:
        rotations = None
    return render_motion(chain, traj, out_path, fps=fps, rotations=rotations,
                         collisions=collisions, meshes=meshes, **kw)
