"""t-SNE latent-space analysis: domain-alignment and action-distribution
plots of a checkpoint's encoders.

    python -m bridgerl_tpu_torch.cli.analyze_latent_space --raw_dir data/raw

The flags of ``scripts/analyze_latent_space.py`` (the reference's
analyze_latent_space.py:162-313), over the port's ``.pth`` checkpoints
(default: every ``*_best.pth`` under ``--ckpt_dir``): the encoders run on
the device (``--device``, default ``cuda``; without a card the run stops
unless ``--device cpu``), t-SNE and the plots on the host. Needs
scikit-learn and matplotlib.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

from . import cli_device, have_packages


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", type=str, default=None,
                   help="Checkpoint path; default: all *_best.pth under --ckpt_dir")
    p.add_argument("--ckpt_dir", type=str, default="checkpoints")
    p.add_argument("--raw_dir", type=str, required=True,
                   help="Directory of raw npz motions (filenames carry action keywords)")
    p.add_argument("--data_dir", type=str, default="data/processed")
    p.add_argument("--out", type=str, default="plots/latent_space")
    p.add_argument("--max_per_action", type=int, default=300)
    p.add_argument("--ref_normalize", action="store_true",
                   help="normalize windows before encoding like the reference "
                        "(analyze_latent_space.py:99-100); models train on raw windows, "
                        "so the default keeps them in-distribution")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not have_packages("analyze_latent_space", "the latent t-SNE", "sklearn.manifold",
                         "matplotlib.pyplot"):
        return 2
    device = cli_device("analyze_latent_space", args.device)
    if device is None:
        return 1
    from ..eval.latent import analyze_checkpoint

    ckpts = [args.ckpt] if args.ckpt else sorted(
        glob.glob(os.path.join(args.ckpt_dir, "*_best.pth")))
    for ck in ckpts:
        for w in analyze_checkpoint(ck, args.raw_dir, args.data_dir, args.out,
                                    args.max_per_action, ref_normalize=args.ref_normalize,
                                    device=device):
            print(f"Saved {w}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
