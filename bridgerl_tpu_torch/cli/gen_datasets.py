"""Regenerate the pinned synthetic dataset trio.

    python -m bridgerl_tpu_torch.cli.gen_datasets --root data
    python -m bridgerl_tpu_torch.cli.gen_datasets --root /tmp/d --n_sequences 2 \
        --min_len 120 --max_len 140

The flags, seeds and outputs of ``scripts/gen_datasets.py``: from seeded
numpy generators, the three datasets the studies read, equal array for
array to the JAX script's:

    dense_w10    W=10, step=1   dense windows
    dense_w64    W=64, step=6   windows
    raw_actions  npz files named by action keyword (the latent analysis),
                 each action's latent frequencies drawn from its band of
                 ``data/synthetic.py::ACTION_BANDS``

The public dataset needs the network; this is the data the studies run on
without it. Runs on the host.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from ..data.synthetic import ACTION_BANDS, G1_DOF, HUMAN_JOINTS, generate_synthetic_dataset
from ..eval.latent import ACTION_KEYWORDS


def gen_raw_actions(root: str, files_per_action: int = 3, T: int = 420, seed: int = 7) -> None:
    """``files_per_action`` paired takes of T frames an action keyword, as
    ``{action}_{i:02d}.npz`` with ``joint_pos`` and ``smplx_pose_body``."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    t = np.arange(T, dtype=np.float32)[:, None]
    for action in ACTION_KEYWORDS:
        lo, hi = ACTION_BANDS[action]
        for i in range(files_per_action):
            freqs = rng.uniform(lo, hi, size=(1, 4)).astype(np.float32)
            phases = rng.uniform(0, 2 * np.pi, size=(1, 4)).astype(np.float32)
            amps = rng.uniform(0.2, 1.0, size=(1, 4)).astype(np.float32)
            latent = amps * np.sin(2 * np.pi * freqs * t + phases)
            w_r = rng.normal(0, 0.6, size=(4, G1_DOF)).astype(np.float32)
            w_h = rng.normal(0, 0.4, size=(4, HUMAN_JOINTS * 3)).astype(np.float32)
            robot = latent @ w_r + 0.05 * rng.normal(0, 1, size=(T, G1_DOF)).astype(np.float32)
            human_aa = (latent @ w_h).reshape(T, HUMAN_JOINTS, 3)
            np.savez(os.path.join(root, f"{action}_{i:02d}.npz"),
                     joint_pos=robot.astype(np.float32),
                     smplx_pose_body=human_aa.astype(np.float32))
    print(f"raw_actions: {len(ACTION_KEYWORDS) * files_per_action} npz -> {root}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", type=str, default="data")
    # 64 long takes (~6.2k frames each): mocap corpora are few long takes
    # with recurring cycles, not many short clips
    p.add_argument("--n_sequences", type=int, default=64)
    p.add_argument("--min_len", type=int, default=6000)
    p.add_argument("--max_len", type=int, default=6400)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    for name, window, step in (("dense_w10", 10, 1), ("dense_w64", 64, 6)):
        a = generate_synthetic_dataset(
            os.path.join(args.root, name), n_sequences=args.n_sequences, min_len=args.min_len,
            max_len=args.max_len, window=window, step=step, seed=args.seed)
        print(f"{name}: {a['g1_train.npy'].shape} windows")
    gen_raw_actions(os.path.join(args.root, "raw_actions"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
