"""Live-retargeting demo: human motion feed -> streaming retargeter -> G1.

    python -m bridgerl_tpu_torch.cli.demo_stream_retarget --ckpt checkpoints/..._best.pth \
        --frames 240 --render demo_stream.gif
    python -m bridgerl_tpu_torch.cli.demo_stream_retarget --render demo_stream.gif   # seed-0 weights

The flags of ``scripts/demo_stream_retarget.py``: the whole deployment
stack, frame by frame, as a live robot controller would consume it:

    synthetic human feed (or a saved (T, 126) npy)
      -> StreamingRetargeter over a frozen serving artifact (``--artifact``,
         else exported from ``--ckpt``, else from the flagship at seed 0);
         each robot frame leaves once final, W + 1 frames after it came in
      -> the G1 replay scene's batched FK
      -> a GIF / MP4, or the live browser viewport (``--render live``)

The stream and the replay run on ``--device`` (default ``cuda``; without a
card the run stops unless ``--device cpu`` asks for the CPU). A GIF or MP4
needs matplotlib and imageio: without them the run stops before it streams.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.optional import RENDER_MODULES
from . import cli_device, have_packages


def stream_feed(module, feed: np.ndarray, step: int
                ) -> Tuple[np.ndarray, List[float], List[int]]:
    """Push ``feed`` (T, in_dim) frame by frame through a
    ``StreamingRetargeter`` over ``module.retarget`` at stride ``step``, then
    flush. Returns the robot frames (T, out_dim), each push's milliseconds
    and the frames each push released (the flush's not counted)."""
    from ..export.streaming import StreamingRetargeter

    h_dim = module.meta["functions"]["retarget"]["input"][2]
    sr = StreamingRetargeter(module.retarget, window=module.window_size, step=step,
                             in_dim=h_dim)
    out_frames, push_ms, released = [], [], []
    for frame in feed:
        t0 = time.perf_counter()
        out = sr.push(frame)
        push_ms.append(1e3 * (time.perf_counter() - t0))
        released.append(len(out))
        if len(out):
            out_frames.append(out)
    tail = sr.flush()
    if len(tail):
        out_frames.append(tail)
    robot = (np.concatenate(out_frames) if out_frames
             else np.zeros((0, sr.out_dim or 0), np.float32))
    return robot, push_ms, released


def drive_g1(robot: np.ndarray, fps: float, device):
    """Replay (T, 29) robot frames on the G1 chain at ``fps`` on ``device``:
    the (T, L, 3) link positions, a tensor on that device."""
    from ..sim.replay import G1ReplayScene

    scene = G1ReplayScene(device=device)
    scene.load(robot, input_fps=float(fps), output_fps=float(fps))
    return scene.rollout()


def human_feed(input_file: Optional[str], frames: int) -> np.ndarray:
    """(frames, 126) raw human frames: the file's first ``frames``, or a
    synthetic take from seed 0 in the 6D form."""
    if input_file:
        return np.load(input_file).astype(np.float32)[:frames]
    from ..data.rotations import compute_6d_rotation
    from ..data.synthetic import synth_pair

    _, human_aa = synth_pair(np.random.default_rng(0), frames)
    return np.asarray(compute_6d_rotation(human_aa), np.float32)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", type=str, default=None,
                   help="trained checkpoint (the flagship at seed 0 when absent)")
    p.add_argument("--artifact", type=str, default=None,
                   help="pre-built serving zip (skips export)")
    p.add_argument("--input_file", type=str, default=None,
                   help="(T, 126) raw human npy; synthetic feed when absent")
    p.add_argument("--data_dir", type=str, default="./data/processed")
    p.add_argument("--frames", type=int, default=240)
    p.add_argument("--step", type=int, default=None,
                   help="streaming stride (default window // 2)")
    p.add_argument("--render", type=str, default="demo_stream.gif",
                   help="output GIF/MP4; 'live' serves the browser viewport")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.render != "live" and not have_packages("demo_stream_retarget", "--render",
                                                   *RENDER_MODULES):
        return 2
    device = cli_device("demo_stream_retarget", args.device)
    if device is None:
        return 1
    from ..export.serialize import (
        export_fresh_artifact,
        export_serving_artifact,
        load_serving_artifact,
    )

    platforms = (device.type,)
    if args.artifact:
        mod = load_serving_artifact(args.artifact, device=device)
    else:
        with tempfile.TemporaryDirectory(prefix="demo_serving_") as tmp:
            art = os.path.join(tmp, "model.zip")
            if args.ckpt:
                export_serving_artifact(args.ckpt, art, data_dir=args.data_dir,
                                        platforms=platforms)
            else:
                export_fresh_artifact(art, window=10, data_dir=args.data_dir,
                                      platforms=platforms)
                print("[WARN] no --ckpt: seed-0 weights (motion flows, retargeting is "
                      "untrained)")
            mod = load_serving_artifact(art, device=device)
    W = mod.window_size
    h_dim = mod.meta["functions"]["retarget"]["input"][2]

    feed = human_feed(args.input_file, args.frames)
    if feed.ndim != 2 or feed.shape[1] != h_dim:
        print(f"demo_stream_retarget: the feed is {feed.shape}, the artifact takes "
              f"(T, {h_dim})", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    robot, push_ms, _ = stream_feed(mod, feed, args.step or max(W // 2, 1))
    wall = time.perf_counter() - t0
    if not len(robot):
        print(f"demo_stream_retarget: feed too short: {feed.shape[0]} frames <= window {W} "
              "produce no output (need at least window+1 frames)", file=sys.stderr)
        return 1
    print(f"streamed {feed.shape[0]} human frames -> {robot.shape[0]} robot frames in "
          f"{wall:.2f}s (median push {np.median(push_ms):.2f} ms, latency {W + 1} frames)")

    traj = drive_g1(robot, args.fps, device)
    from ..sim.urdf import load_g1_chain

    chain = load_g1_chain()
    if args.render == "live":
        from ..sim.live import build_viewer_html, serve_viewer

        serve_viewer(build_viewer_html(chain, traj.cpu().numpy(), fps=float(args.fps),
                                       title="streamed retargeting"))
    else:
        from ..sim.render import render_motion

        print(f"wrote {render_motion(chain, traj, args.render, fps=args.fps)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
