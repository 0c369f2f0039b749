"""Render G1 motion ``.npy`` files to GIF or MP4 videos.

    python -m bridgerl_tpu_torch.cli.render_video --input motions/ --output_dir videos

The flags of ``scripts/render_video.py`` (the reference's
render_video.py:84-188): a file, or every ``.npy`` of a directory, replayed
on the device and drawn as a skeleton, the collision volumes
(``--volumetric``) or the vendor meshes (``--mesh``, the volumes where none
are found), one ``<stem>.<format>`` each. ``--device`` (default ``cuda``);
without a card the run stops unless ``--device cpu``. Needs matplotlib and
imageio.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

from . import cli_device, have_packages
from ..utils.optional import RENDER_MODULES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", type=str, required=True, help="npy file or directory")
    p.add_argument("--output_dir", type=str, default="videos")
    p.add_argument("--input_fps", type=int, default=20)
    p.add_argument("--output_fps", type=int, default=25)
    p.add_argument("--format", type=str, default="gif", choices=["gif", "mp4"])
    p.add_argument("--max_frames", type=int, default=200)
    p.add_argument("--view", type=str, default="front")
    p.add_argument("--volumetric", action="store_true",
                   help="render the collision-primitive body volumes instead of the skeleton")
    p.add_argument("--mesh", action="store_true",
                   help="render the vendor visual STL meshes (--volumetric where none are found)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not have_packages("render_video", "rendering", *RENDER_MODULES):
        return 2
    device = cli_device("render_video", args.device)
    if device is None:
        return 1
    import numpy as np

    from ..sim import G1ReplayScene, load_g1_chain
    from ..sim.render import render_scene

    files = [args.input] if args.input.endswith(".npy") else sorted(
        glob.glob(os.path.join(args.input, "*.npy")))
    if not files:
        print(f"No npy files under {args.input}")
        return 0
    chain = load_g1_chain()
    scene = G1ReplayScene(chain, device=device)
    os.makedirs(args.output_dir, exist_ok=True)
    for f in files:
        raw = np.load(f)
        if raw.ndim != 2 or raw.shape[1] != chain.num_actuated:
            print(f"[SKIP] {f}: shape {raw.shape}")
            continue
        scene.load(raw, args.input_fps, args.output_fps)
        stem = os.path.splitext(os.path.basename(f))[0]
        out = render_scene(scene, os.path.join(args.output_dir, f"{stem}.{args.format}"),
                           args.output_fps, volumetric=args.volumetric, mesh=args.mesh,
                           max_frames=args.max_frames, view=args.view)
        print(f"[OK] {f} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
