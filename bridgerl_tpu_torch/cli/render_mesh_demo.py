"""Side-by-side demo: the volumetric body against the vendor STL meshes.

    python -m bridgerl_tpu_torch.cli.render_mesh_demo \
        --input motions/recon_transformer_FullSeq_W10_idx0.npy --out plots/mesh_vs_volumetric.gif

The flags of ``scripts/render_mesh_demo.py``: one clip replayed on the
device and drawn twice a frame, the collision volumes on the left and the
vendor visual meshes on the right, stitched into one GIF. It stops where no
vendor meshes are found (``sim/mesh.py``). ``--device`` (default ``cuda``);
without a card the run stops unless ``--device cpu``. Needs matplotlib and
imageio.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from . import cli_device, have_packages
from ..utils.optional import RENDER_MODULES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", default="motions/recon_transformer_FullSeq_W10_idx0.npy")
    p.add_argument("--out", default="plots/mesh_vs_volumetric.gif")
    p.add_argument("--start", type=int, default=1000)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--view", default="front")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not have_packages("render_mesh_demo", "rendering", *RENDER_MODULES):
        return 2
    device = cli_device("render_mesh_demo", args.device)
    if device is None:
        return 1
    import numpy as np

    from ..sim import G1ReplayScene, load_g1_chain, load_g1_collisions, render_frame
    from ..sim.mesh import load_g1_meshes
    from ..utils.optional import imageio

    chain = load_g1_chain()
    meshes = load_g1_meshes(chain)
    if not meshes:
        print("render_mesh_demo: vendor STL meshes unreachable; nothing to demo",
              file=sys.stderr)
        return 1
    collisions = load_g1_collisions()
    scene = G1ReplayScene(chain, device=device)
    scene.load(np.load(args.input)[args.start:args.start + args.frames], 20, 20)
    traj, rots = (a.cpu().numpy() for a in scene.rollout_full())

    flat = traj.reshape(-1, 3)
    lim = max(float(np.abs(flat - flat.mean(0)).max()) * 1.15, 0.3)
    frames = []
    for t in range(0, traj.shape[0], args.stride):
        left = render_frame(chain, traj[t], None, view=args.view, lim=lim, rotations=rots[t],
                            collisions=collisions)
        right = render_frame(chain, traj[t], None, view=args.view, lim=lim, rotations=rots[t],
                             meshes=meshes)
        h = min(left.shape[0], right.shape[0])
        frames.append(np.concatenate([left[:h], right[:h]], axis=1))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    imageio().mimsave(args.out, frames, duration=1000.0 / args.fps)
    print(f"[INFO] wrote {args.out} ({len(frames)} frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
