"""Convert a LAFAN-style retargeted CSV into a motion npz with body states.

    python -m bridgerl_tpu_torch.cli.csv_to_npz --input_file motion.csv --output_file motion.npz

The flags and output of ``scripts/csv_to_npz.py`` (the reference's
third-party csv_to_npz.py): CSV rows are [root_pos (3), root quaternion
xyzw (4), dof (29)] a frame. Where the reference replays them through Isaac,
the resampling (lerp, root slerp, velocities), the root's rotation matrices
and the batched FK run here on the device; the host turns the link
rotations into wxyz quaternions (unit, w >= 0, also at half turns, where
the JAX script's formula is not) and angular velocities (numpy). The npz
holds ``fps``, ``joint_pos`` (T, 29), ``joint_vel``, ``body_pos_w`` (T, L,
3), ``body_quat_w`` (T, L, 4 wxyz), ``body_lin_vel_w`` and
``body_ang_vel_w``. ``--wandb_registry`` uploads it where wandb and a
network are present, as the reference does (csv_to_npz.py:301-311).
``--device`` (default ``cuda``); without a card the run stops unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import cli_device


def matrix_to_wxyz(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) unit wxyz quaternion with w >= 0 (numpy).

    Shepperd's method: each quaternion is read off the largest of 4w², 4x²,
    4y², 4z² (1 + trace, 1 + 2 r_ii - trace), so no division is by a number
    near 0. Where w is the largest this is the JAX script's formula
    (``scripts/csv_to_npz.py::matrix_to_wxyz``) operation for operation;
    that formula divides by w alone, which goes to 0 at half turns, and
    there returns quaternions far from unit length."""
    m = R
    t = np.trace(m, axis1=-2, axis2=-1)
    d = np.stack([1.0 + t, 1.0 + 2.0 * m[..., 0, 0] - t, 1.0 + 2.0 * m[..., 1, 1] - t,
                  1.0 + 2.0 * m[..., 2, 2] - t], axis=-1)
    k = np.argmax(d, axis=-1)
    s = np.sqrt(np.maximum(np.take_along_axis(d, k[..., None], -1)[..., 0], 1e-12))
    big = s / 2.0            # the largest component
    den = 2.0 * s            # = 4 x that component
    sub = {(2, 1): m[..., 2, 1] - m[..., 1, 2], (0, 2): m[..., 0, 2] - m[..., 2, 0],
           (1, 0): m[..., 1, 0] - m[..., 0, 1]}
    add = {(0, 1): m[..., 0, 1] + m[..., 1, 0], (0, 2): m[..., 0, 2] + m[..., 2, 0],
           (1, 2): m[..., 1, 2] + m[..., 2, 1]}
    # rows: the component that is largest; columns: w, x, y, z
    cases = [[big, sub[2, 1] / den, sub[0, 2] / den, sub[1, 0] / den],
             [sub[2, 1] / den, big, add[0, 1] / den, add[0, 2] / den],
             [sub[0, 2] / den, add[0, 1] / den, big, add[1, 2] / den],
             [sub[1, 0] / den, add[0, 2] / den, add[1, 2] / den, big]]
    q = np.stack([np.choose(k, [c[i] for c in cases]) for i in range(4)], axis=-1)
    return np.where(q[..., :1] < 0, -q, q)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input_file", type=str, required=True)
    p.add_argument("--input_fps", type=int, default=30)
    p.add_argument("--output_fps", type=int, default=50)
    p.add_argument("--output_file", type=str, default="motion.npz")
    p.add_argument("--frame_range", type=int, nargs=2, default=None,
                   help="1-based inclusive start/end rows, like the reference")
    p.add_argument("--wandb_registry", type=str, default=None,
                   help="Optional wandb registry name to upload the artifact to")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device("csv_to_npz", args.device)
    if device is None:
        return 1
    from ..data.rotations import quat_to_matrix
    from ..sim import BatchedFK, load_g1_chain, load_motion

    raw = np.genfromtxt(args.input_file, delimiter=",").astype(np.float32)
    if args.frame_range:
        raw = raw[args.frame_range[0] - 1:args.frame_range[1]]
    root_pos, quat_xyzw, dof = raw[:, 0:3], raw[:, 3:7], raw[:, 7:]
    quat_wxyz = np.concatenate([quat_xyzw[:, 3:4], quat_xyzw[:, 0:3]], axis=1)
    chain = load_g1_chain()
    if dof.shape[1] != chain.num_actuated:
        raise SystemExit(f"csv_to_npz: the csv has {dof.shape[1]} dof columns; "
                         f"expected {chain.num_actuated}")

    motion = load_motion(dof, args.input_fps, args.output_fps, base_pos=root_pos,
                         base_rot=quat_wxyz, device=device)
    T = motion.num_frames
    dt = 1.0 / args.output_fps
    # FK at the real (resampled) root
    base_R = quat_to_matrix(motion.base_rot, scalar_first=True)        # (T, 3, 3)
    body_pos, body_rot = (a.cpu().numpy() for a in BatchedFK(chain)(
        motion.dof_pos, motion.base_pos, base_R))

    body_lin_vel = np.gradient(body_pos, dt, axis=0)
    # angular velocity by the SO(3) difference: axis_angle(R_t^T R_t+1) / dt
    rel = np.einsum("tlij,tlik->tljk", body_rot[:-1], body_rot[1:])
    skew = (rel - np.swapaxes(rel, -1, -2)) / 2.0
    w = np.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], axis=-1) / dt
    np.savez(
        args.output_file,
        fps=np.asarray(args.output_fps),
        joint_pos=motion.dof_pos.cpu().numpy(),
        joint_vel=motion.dof_vel.cpu().numpy(),
        body_pos_w=body_pos,
        body_quat_w=matrix_to_wxyz(body_rot),
        body_lin_vel_w=body_lin_vel,
        body_ang_vel_w=np.concatenate([w, w[-1:]], axis=0),
    )
    print(f"[OK] {T} frames @ {args.output_fps}fps -> {args.output_file}")

    if args.wandb_registry:
        try:
            import wandb

            run = wandb.init(project="csv_to_npz")
            artifact = wandb.Artifact(name=Path(args.input_file).stem, type="motions")
            artifact.add_file(args.output_file)
            run.log_artifact(artifact, target_path=args.wandb_registry)
            run.finish()
        except Exception as e:   # no wandb, no network: the npz stands alone
            print(f"[WARN] wandb upload skipped: {e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
