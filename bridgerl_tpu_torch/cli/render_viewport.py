"""Viewport-style render: a queue of motions -> evenly spaced frame shots ->
one GIF each.

    python -m bridgerl_tpu_torch.cli.render_viewport --input motions/

The flags of ``scripts/render_viewport.py`` (the reference's
render_viewport.py: the file queue 140-154, ``--max_shots`` 157-163, frame
capture 199-201, GIF 210-218): each motion replayed on the device, at most
``--max_shots`` frames drawn from one camera with one framing, and
``<stem>.gif`` written (``--keep_frames`` keeps the PNGs). ``--device``
(default ``cuda``); without a card the run stops unless ``--device cpu``.
Needs matplotlib and imageio.
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
    p.add_argument("--output_dir", type=str, default="plots/viewport")
    p.add_argument("--input_fps", type=int, default=20)
    p.add_argument("--output_fps", type=int, default=50)
    p.add_argument("--max_shots", type=int, default=60,
                   help="Max frames captured per motion (decimated evenly)")
    p.add_argument("--view", type=str, default="far")
    p.add_argument("--keep_frames", action="store_true",
                   help="Keep per-frame PNGs next to the GIF")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not have_packages("render_viewport", "rendering", *RENDER_MODULES):
        return 2
    device = cli_device("render_viewport", args.device)
    if device is None:
        return 1
    import numpy as np

    from ..sim import G1ReplayScene, load_g1_chain, render_frame
    from ..utils.optional import imageio

    iio = imageio()
    chain = load_g1_chain()
    scene = G1ReplayScene(chain, device=device)
    files = [args.input] if args.input.endswith(".npy") else sorted(
        glob.glob(os.path.join(args.input, "*.npy")))
    os.makedirs(args.output_dir, exist_ok=True)
    for f in files:
        raw = np.load(f)
        if raw.ndim != 2 or raw.shape[1] != chain.num_actuated:
            print(f"[SKIP] {f}: shape {raw.shape}")
            continue
        scene.load(raw, args.input_fps, args.output_fps)
        traj = scene.rollout().cpu().numpy()
        T = traj.shape[0]
        shot_idx = np.linspace(0, T - 1, min(args.max_shots, T)).astype(int)
        flat = traj.reshape(-1, 3)
        lim = max(float(np.abs(flat - flat.mean(0)).max()) * 1.15, 0.3)
        stem = os.path.splitext(os.path.basename(f))[0]
        frames = []
        for k, t in enumerate(shot_idx):
            if args.keep_frames:
                png = os.path.join(args.output_dir, f"{stem}_shot{k:03d}.png")
                render_frame(chain, traj[t], png, view=args.view, lim=lim)
                frames.append(iio.imread(png))
            else:
                frames.append(render_frame(chain, traj[t], None, view=args.view, lim=lim))
        gif = os.path.join(args.output_dir, f"{stem}.gif")
        iio.mimsave(gif, frames, fps=10)
        print(f"[OK] {f} -> {gif} ({len(frames)} shots)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
