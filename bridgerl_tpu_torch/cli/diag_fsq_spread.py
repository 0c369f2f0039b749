"""Diagnose the FSQ latent spread of a trained checkpoint.

    python -m bridgerl_tpu_torch.cli.diag_fsq_spread --ckpt <fsq or hybrid .pth> \
        --data_dir data/dense_w64

``scripts/diag_fsq_spread.py`` for the port: the reference's FSQ rounds an
unbounded projection, so the code spread is set by the learned scale of
``project_in(z_e)``. On the first ``--batch`` robot windows of
``g1_train.npy`` it reports the robot encoder's output scale, each level's
pre-round projection (std, min, max), the occupied integer range per level
against the nominal level count, and the unique codes against the nominal
capacity, ending with the JAX script's JSON line. The encoder runs on
``--device`` (default ``cuda``; without a card the run stops unless
``--device cpu`` asks for the CPU); the statistics are numpy on the host.
``--cpu`` is accepted for the JAX script's command lines.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from . import cli_device
from ..eval.studies import load_teacher

PROG = "diag_fsq_spread"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--data_dir", default="data/dense_w64")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--cpu", action="store_true",
                   help="accepted for the JAX script's command lines; --device picks the device")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def robot_latents(model, data_dir: str, batch: int, device) -> np.ndarray:
    """The robot encoder's float32 output on the first ``batch`` windows of
    ``g1_train.npy`` (read through a memory map)."""
    g1 = np.load(os.path.join(data_dir, "g1_train.npy"), mmap_mode="r")
    x = torch.as_tensor(np.array(g1[:batch], np.float32), device=device)
    with torch.inference_mode():
        return model.robot_encoder(x).float().cpu().numpy()


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device(PROG, args.device)
    if device is None:
        return 2
    loaded = load_teacher(PROG, args.ckpt, device)
    if loaded is None:
        return 2
    model, exp = loaded
    cfg = exp.model
    fsq = getattr(model.quantizer, "fsq", model.quantizer)   # hybrid: quantizer.fsq
    if not hasattr(fsq, "levels"):
        print(f"{PROG}: method {cfg.method} has no FSQ stage", file=sys.stderr)
        return 2
    print(f"ckpt: {args.ckpt}\narch={cfg.arch} method={cfg.method} "
          f"W={cfg.window_size} torch_init={cfg.torch_init}")

    z = robot_latents(model, args.data_dir, args.batch, device)
    print(f"\nz_e: shape={z.shape} std={z.std():.3f} "
          f"absmax={np.abs(z).max():.2f} mean={z.mean():+.3f}")

    kin = fsq.project_in.weight.detach().float().cpu().numpy().T   # (in, levels)
    bin_ = fsq.project_in.bias.detach().float().cpu().numpy()
    zp = z.reshape(-1, z.shape[-1]) @ kin + bin_
    levels = list(cfg.fsq_levels)
    nominal = int(np.prod(levels))
    zr = np.round(zp)

    print(f"\nproject_in kernel scale: std={kin.std():.4f} (fan_in={kin.shape[0]})")
    print(f"{'lvl':>4} {'nominal':>8} {'zp_std':>8} {'zp_min':>8} {'zp_max':>8} "
          f"{'occ_int_range':>14} {'occupied/nominal':>17}")
    occupied = []
    for d, L in enumerate(levels):
        occ = len(np.unique(zr[:, d]))
        occupied.append(occ)
        print(f"{L:>4} {L:>8} {zp[:, d].std():>8.2f} {zp[:, d].min():>8.2f} "
              f"{zp[:, d].max():>8.2f} {occ:>14d} {occ / L:>17.2f}")

    basis = np.array([int(np.prod(levels[:i])) for i in range(len(levels))], np.float32)
    idx = (zr * basis).sum(-1).astype(np.int64)
    uniq = len(np.unique(idx))
    print(f"\nunique codes: {uniq} / nominal {nominal} = {uniq / nominal:.2f}x "
          f"(reference class: 1.36x, README.md:356)")
    print(f"product of occupied per-level ranges: {int(np.prod(occupied))}")
    print(json.dumps({"uniq": uniq, "nominal": nominal, "ratio": round(uniq / nominal, 3),
                      "z_e_std": round(float(z.std()), 4),
                      "zp_std": [round(float(zp[:, d].std()), 3) for d in range(len(levels))]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
