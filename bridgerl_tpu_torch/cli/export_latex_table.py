"""Print the LaTeX table of the ablation results.

    python -m bridgerl_tpu_torch.cli.export_latex_table --dir results

The flag and output of ``scripts/export_latex_table.py`` (the reference's
export_latex_table.py), over the history JSONs in ``--dir``
(``eval/latex.py``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", type=str, default="results")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from ..eval.latex import generate_latex

    print("-" * 60)
    print("LaTeX Table Code (Copy below):")
    print("-" * 60)
    print()
    print(generate_latex(args.dir))
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
