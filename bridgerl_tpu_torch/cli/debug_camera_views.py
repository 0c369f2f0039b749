"""Shoot a motion's first pose from the preset cameras.

    python -m bridgerl_tpu_torch.cli.debug_camera_views --input_file motion.npy

The flags of ``scripts/debug_camera_views.py`` (the reference's
debug_camera_views.py): ``view_{front,side,back,far}.png`` in
``--output_dir``. ``--device`` (default ``cuda``); without a card the run
stops unless ``--device cpu``. Needs matplotlib.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from . import cli_device, have_packages


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input_file", type=str, required=True, help="npy (T, 29)")
    p.add_argument("--output_dir", type=str, default="plots/camera_debug")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not have_packages("debug_camera_views", "rendering", "matplotlib.pyplot"):
        return 2
    device = cli_device("debug_camera_views", args.device)
    if device is None:
        return 1
    import numpy as np

    from ..sim import G1ReplayScene, debug_camera_views, load_g1_chain

    chain = load_g1_chain()
    scene = G1ReplayScene(chain, device=device)
    scene.load(np.load(args.input_file), 20, 20)
    for path in debug_camera_views(chain, scene.rollout()[0], args.output_dir):
        print(f"Saved {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
