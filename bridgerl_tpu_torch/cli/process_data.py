"""Preprocess paired npz motions into the windowed training artifacts.

    python -m bridgerl_tpu_torch.cli.process_data --synthetic --window 10 --step 2
    python -m bridgerl_tpu_torch.cli.process_data --input_dir RAW --output_dir data/processed

The flags and artifact names of ``scripts/process_data.py``. ``--synthetic``
generates paired data from ``--seed`` instead of reading npz files (the
public dataset needs the network). Runs on the host; needs no card.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input_dir", type=str,
                   default="./data/raw/unzipped/extended_datasets/lafan1_dataset/g1")
    p.add_argument("--output_dir", type=str, default="./data/processed")
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--step", type=int, default=20)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="Generate synthetic paired data instead of reading npz")
    p.add_argument("--n_sequences", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.synthetic:
        from ..data.synthetic import generate_synthetic_dataset
        arrays = generate_synthetic_dataset(
            args.output_dir, n_sequences=args.n_sequences, window=args.window,
            step=args.step, seed=args.seed)
        print(f"Synthetic data: robot {arrays['g1_train.npy'].shape}, "
              f"human {arrays['human_train.npy'].shape} -> {args.output_dir}")
    else:
        from ..data.pipeline import process_paired_data
        process_paired_data(args.input_dir, args.output_dir, window=args.window,
                            step=args.step, overwrite=args.overwrite)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
