"""Print the keys, shapes and dtypes of npz files.

    python -m bridgerl_tpu_torch.cli.inspect_npz data/raw_actions/walk_00.npz
    python -m bridgerl_tpu_torch.cli.inspect_npz data/raw/unzipped     # the first file found

The flags and output of ``scripts/inspect_npz.py`` (the reference's
scripts/data/inspect_npz.py): a path ending in ``.npz`` is that file, else
the first npz file under the directory. Runs on the host.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", nargs="?", default="data/raw/unzipped",
                   help="npz file or directory to scan")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from ..data.pipeline import inspect_npz

    files = [args.path] if args.path.endswith(".npz") else sorted(
        glob.glob(os.path.join(args.path, "**", "*.npz"), recursive=True))[:1]
    if not files:
        print(f"No npz files under {args.path}")
        return 0
    for f in files:
        print(f"== {f} ==")
        for k, (shape, dtype) in inspect_npz(f).items():
            print(f"  {k}: shape={shape} dtype={dtype}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
