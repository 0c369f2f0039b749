"""Training logs -> metric curves, an overview and a radar chart.

    python -m bridgerl_tpu_torch.cli.plot_results --dir results --out plots/metrics

The flags of ``scripts/plot_results.py`` (the reference's
plot_results.py:200-218), over the history JSONs the port's trainer writes
(``eval/plots.py``). Plots on the host; needs matplotlib.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from . import have_packages


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", type=str, default="results")
    p.add_argument("--out", type=str, default="plots/metrics")
    p.add_argument("--filter", type=str, default=None)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not have_packages("plot_results", "plotting", "matplotlib.pyplot"):
        return 2
    from ..eval.plots import plot_all

    written = plot_all(args.dir, args.out, args.filter)
    for w in written:
        print(f"Saved {w}")
    if not written:
        print(f"No log files found in {args.dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
