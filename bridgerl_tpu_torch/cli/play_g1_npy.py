"""Replay a (T, 29) G1 motion ``.npy`` through the kinematic scene.

    python -m bridgerl_tpu_torch.cli.play_g1_npy --input_file motion.npy --render replay.gif

The flags of ``scripts/play_g1_npy.py`` (the reference's
play_g1_npy.py: ``--input_file --input_fps --output_fps --output_name``):
the motion is resampled and replayed through the batched FK on the card,
its replay steps/s printed, and with ``--render`` drawn to a GIF or MP4 as a
line skeleton, the collision volumes (``--volumetric``) or the vendor
meshes (``--mesh``, the volumes where none are found). ``--device``
(default ``cuda``) picks the device; without a card the run stops unless
``--device cpu`` asks for the CPU. Rendering needs matplotlib and imageio.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

from ..utils.optional import RENDER_MODULES
from . import cli_device, have_packages


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input_file", type=str, required=True, help="Path to .npy (T, 29)")
    p.add_argument("--input_fps", type=int, default=20)
    p.add_argument("--output_fps", type=int, default=50)
    p.add_argument("--output_name", type=str, default="debug")
    p.add_argument("--render", type=str, default=None,
                   help="Optional output GIF/MP4 path for the render")
    p.add_argument("--urdf", type=str, default=None,
                   help="Optional URDF path (default: bundled G1 29-DoF spec)")
    p.add_argument("--loops", type=int, default=1, help="Replay passes to time")
    p.add_argument("--volumetric", action="store_true",
                   help="Render the collision-primitive body volumes instead of the skeleton")
    p.add_argument("--mesh", action="store_true",
                   help="Render the vendor visual STL meshes (--volumetric where none are found)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.render and not have_packages("play_g1_npy", "--render", *RENDER_MODULES):
        return 2
    device = cli_device("play_g1_npy", args.device)
    if device is None:
        return 1
    import numpy as np
    import torch

    from ..sim import G1ReplayScene, load_g1_chain
    from ..sim.render import render_scene

    chain = load_g1_chain(args.urdf)
    scene = G1ReplayScene(chain, device=device)
    raw = np.load(args.input_file)
    if raw.ndim != 2 or raw.shape[1] != chain.num_actuated:
        print(f"play_g1_npy: expected (T, {chain.num_actuated}), got {raw.shape}",
              file=sys.stderr)
        return 1
    motion = scene.load(raw, args.input_fps, args.output_fps)
    print(f"[INFO] Loaded {raw.shape[0]} frames @ {args.input_fps}fps -> "
          f"{motion.num_frames} frames @ {args.output_fps}fps")

    float(scene.rollout().sum())     # warm-up; the host read is the barrier
    t0 = time.perf_counter()
    for _ in range(args.loops):
        traj = scene.rollout()
    float(traj.sum())
    sps = args.loops * motion.num_frames / (time.perf_counter() - t0)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[INFO] Replay '{args.output_name}': {motion.num_frames} frames, "
          f"{sps:,.0f} steps/sec on {where}")

    if args.render:
        out = render_scene(scene, args.render, min(args.output_fps, 25),
                           volumetric=args.volumetric, mesh=args.mesh)
        print(f"[INFO] Rendered {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
