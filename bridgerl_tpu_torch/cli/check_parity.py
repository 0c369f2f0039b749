"""Evaluate the quality-parity criteria and write PARITY.md.

    python -m bridgerl_tpu_torch.cli.check_parity --log_dir results --out PARITY.md

The flags and output of ``scripts/check_parity.py``: the criteria of
``eval/parity.py`` over ``--log_dir``'s histories and the generative-stack
criteria over the committed experiment JSONs under ``abruns/`` (read from
the working directory), rendered as markdown to ``--out`` and printed.
Exit 1 if any evaluable criterion fails.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--log_dir", type=str, default="results")
    p.add_argument("--out", type=str, default="PARITY.md")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from ..eval.parity import evaluate_generation, evaluate_parity, render_parity_md

    crits = evaluate_parity(args.log_dir) + evaluate_generation()
    md = render_parity_md(crits, args.log_dir)
    with open(args.out, "w") as f:
        f.write(md)
    print(md)
    return 1 if any(c.passed is False for c in crits) else 0


if __name__ == "__main__":
    raise SystemExit(main())
