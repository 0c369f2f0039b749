"""Live interactive replay viewport for a (T, 29) G1 motion ``.npy``.

    python -m bridgerl_tpu_torch.cli.live_viewer --input_file motion.npy
    python -m bridgerl_tpu_torch.cli.live_viewer --input_file m.npy --html viewer.html  # no server

The flags of ``scripts/live_viewer.py`` (the interactive counterpart of the
reference's Omniverse viewport loop, play_g1_npy.py:194-210): the motion is
resampled and its link poses computed by the replay scene on the device,
then one self-contained page (``sim/live.py``) draws the skeleton, the
collision capsules (``--volumetric``) or the vendor meshes (``--mesh``, the
capsules where none are found), written with ``--html`` or served on
localhost. ``--device`` (default ``cuda``); without a card the run stops
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from . import cli_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input_file", type=str, required=True, help="Path to .npy (T, 29)")
    p.add_argument("--input_fps", type=int, default=20)
    p.add_argument("--output_fps", type=int, default=50)
    p.add_argument("--urdf", type=str, default=None,
                   help="Optional URDF path (default: bundled G1 29-DoF spec)")
    p.add_argument("--html", type=str, default=None,
                   help="Write the page here instead of serving it")
    p.add_argument("--port", type=int, default=8731)
    p.add_argument("--volumetric", action="store_true",
                   help="render the collision-primitive body volumes instead of the skeleton")
    p.add_argument("--mesh", action="store_true",
                   help="render the vendor visual STL meshes (--volumetric where none are found)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device("live_viewer", args.device)
    if device is None:
        return 1
    import numpy as np

    from ..sim import G1ReplayScene, load_g1_chain, load_g1_collisions
    from ..sim.live import build_viewer_html, meshes_payload, motion_to_volumes, serve_viewer
    from ..sim.mesh import load_g1_meshes

    chain = load_g1_chain(args.urdf)
    raw = np.load(args.input_file)
    if raw.ndim != 2 or raw.shape[1] != chain.num_actuated:
        raise SystemExit(f"live_viewer: expected (T, {chain.num_actuated}), got {raw.shape}")
    scene = G1ReplayScene(chain, device=device)
    motion = scene.load(raw, args.input_fps, args.output_fps)
    print(f"[INFO] {raw.shape[0]} frames @ {args.input_fps}fps -> "
          f"{motion.num_frames} frames @ {args.output_fps}fps")
    positions, rotations = (a.cpu().numpy() for a in scene.rollout_full())
    volumes = mesh_payload = None
    if args.mesh:
        meshes = load_g1_meshes(chain)
        if meshes:
            mesh_payload = meshes_payload(chain, meshes)
        else:
            print("[WARN] vendor STL meshes unreachable; falling back to --volumetric")
            args.volumetric = True
    if args.volumetric and mesh_payload is None:
        prims = load_g1_collisions()
        if prims:
            volumes = motion_to_volumes(chain, motion.dof_pos.cpu().numpy(), prims)
        else:
            print("[WARN] no collision primitives in the bundled spec; rendering skeleton")
    html = build_viewer_html(chain, positions, fps=args.output_fps,
                             title=Path(args.input_file).stem, volumes=volumes,
                             meshes=mesh_payload,
                             rotations=rotations if mesh_payload is not None else None)
    if args.html:
        Path(args.html).write_text(html)
        print(f"[INFO] Wrote {args.html} ({len(html) / 1e6:.1f} MB, self-contained)")
    else:
        serve_viewer(html, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
