"""Draw the action-conditioned prior's scaling ladder to PNG.

    python -m bridgerl_tpu_torch.cli.plot_prior_conditioned   # -> plots/prior_conditioned.png

``scripts/plot_prior_conditioned.py`` for the port. Reads
``abruns/prior_cond/conditioned.json`` (``cli.exp_prior_conditioned``'s)
under the repository root and draws two panels over the takes per class:
conditioned against unconditioned grouped-val CE (the gap is the
conditioning gain in nats on held-out takes), and the held-out and train
prior-as-classifier accuracies and the code-space histogram match of
conditioned samples against the chance floor. Plots on the host; needs
matplotlib (the series need only numpy).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import have_packages

REPO = Path(__file__).resolve().parents[2]


def build_parser() -> argparse.ArgumentParser:
    return argparse.ArgumentParser(description=__doc__.split("\n\n")[0])


def load_arms(repo: Path) -> dict:
    """takes per class -> arm of ``abruns/prior_cond/conditioned.json``."""
    data = json.loads((repo / "abruns" / "prior_cond" / "conditioned.json").read_text())
    arms = {int(k.removeprefix("perclass")): v for k, v in data.items()
            if k.removeprefix("perclass").isdigit()}
    return dict(sorted(arms.items()))


def series(arms: dict) -> dict:
    """The curves the figure draws, by name, over ``per_class``, and the
    class count of its chance line."""
    return {
        "per_class": list(arms),
        "cond_val_ce_best": [a["cond_val_ce_best"] for a in arms.values()],
        "uncond_val_ce_best": [a["uncond_val_ce_best"] for a in arms.values()],
        "classifier_accuracy_val": [a["classifier_accuracy_val"] for a in arms.values()],
        "classifier_accuracy_train": [a["classifier_accuracy_train"] for a in arms.values()],
        "histogram_match": [a["histogram_match"]["accuracy"] for a in arms.values()],
        "n_classes": max(a["histogram_match"]["n_classes"] for a in arms.values()),
    }


def draw(s: dict, out: Path) -> Path:
    from ..eval.plots import GRID, INK, INK_2, PALETTE
    from ..utils.optional import pyplot

    plt = pyplot("plot_prior_conditioned")
    per = np.array(s["per_class"])
    n_cls = s["n_classes"]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10.4, 4.0), dpi=140)
    for ax in (ax1, ax2):
        ax.set_xscale("log", base=2)
        ax.set_xticks(per, [str(t) for t in per])
        ax.set_xlabel("labeled takes per class (log2)", color=INK_2)
        ax.grid(True, color=GRID, linewidth=0.7)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        for side in ("left", "bottom"):
            ax.spines[side].set_color(GRID)
        ax.tick_params(colors=INK_2)

    c_main, c_alt, c_3 = PALETTE[0], PALETTE[1], PALETTE[2]
    ax1.plot(per, s["uncond_val_ce_best"], "o--", color=c_alt, lw=2, ms=7,
             label="unconditioned")
    ax1.plot(per, s["cond_val_ce_best"], "o-", color=c_main, lw=2, ms=7,
             label="class-conditioned")
    ax1.set_ylabel("grouped-val CE (nats)", color=INK)
    ax1.set_title("conditioning information gain", color=INK, fontsize=11)
    ax1.legend(frameon=False, fontsize=9, labelcolor=INK_2)

    ax2.plot(per, s["classifier_accuracy_val"], "o-", color=c_main, lw=2, ms=7,
             label="classifier (held-out takes)")
    ax2.plot(per, s["classifier_accuracy_train"], "o--", color=c_alt, lw=1.6, ms=5,
             label="classifier (train takes)")
    ax2.plot(per, s["histogram_match"], "s-", color=c_3, lw=2, ms=6,
             label="sample histogram match")
    ax2.axhline(1.0 / n_cls, color=INK_2, lw=1.2, ls=":")
    ax2.text(per[0], 1.0 / n_cls + 0.02, f"chance (1/{n_cls})", color=INK_2, fontsize=8)
    ax2.set_ylim(0, 1.05)
    ax2.set_ylabel("accuracy", color=INK)
    ax2.set_title("what the class token encodes", color=INK, fontsize=11)
    ax2.legend(frameon=False, fontsize=9, labelcolor=INK_2)

    fig.suptitle("Action-conditioned motion-token prior: labeled-corpus scaling "
                 "(frozen K4 tokenizer)", color=INK, fontsize=12)
    fig.tight_layout(rect=(0, 0, 1, 0.95))
    out.parent.mkdir(exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    build_parser().parse_args(argv)
    arms = load_arms(REPO)
    if len(arms) < 2:
        print("need >=2 arms in abruns/prior_cond/conditioned.json", file=sys.stderr)
        return 1
    if not have_packages("plot_prior_conditioned", "plotting", "matplotlib.pyplot"):
        return 2
    out = draw(series(arms), REPO / "plots" / "prior_conditioned.png")
    print(f"[INFO] wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
