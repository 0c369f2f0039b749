"""Draw the prior corpus-scaling curves to PNG.

    python -m bridgerl_tpu_torch.cli.plot_prior_scaling   # -> plots/prior_scaling.png

``scripts/plot_prior_scaling.py`` for the port. Reads
``abruns/prior_scale/scaling.json`` (select=train arms),
``abruns/prior_scale_val/scaling.json`` (select=val arms) and
``abruns/prior_scale2/scaling.json`` under the repository root, merges
them per take count (later directories win ties; tagged arms are not
points on the take-count axis), and draws two panels over the take count:
the grouped-val CE at epoch 0 and at its best epoch against the uniform
floor (6.37 nats, the mean log-vocab of the 5 hybrid code streams), and
the held-out prompted continuation's truth MSE (mean over offsets) against
the retrieval floor (real val windows' nearest train window) and the
tokenizer's recon floor. The JSONs are ``cli.exp_prior_scaling``'s. Plots on
the host; needs matplotlib (the series need only numpy).
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
UNIFORM_CE = 6.37   # mean log-vocab over the 5 hybrid code streams
# the same frozen teacher everywhere, so one take-count axis; select=val
# directories load last and win ties
SOURCES = ("prior_scale", "prior_scale_val", "prior_scale2")


def build_parser() -> argparse.ArgumentParser:
    return argparse.ArgumentParser(description=__doc__.split("\n\n")[0])


def load_arms(repo: Path) -> dict:
    """take count -> arm, merged over SOURCES."""
    arms: dict = {}
    for sub in SOURCES:
        f = repo / "abruns" / sub / "scaling.json"
        if f.exists():
            for k, v in json.loads(f.read_text()).items():
                n = k.removeprefix("takes")
                if n.isdigit():   # tagged arms (capacity, ss variants) are off this axis
                    arms[int(n)] = v
    return dict(sorted(arms.items()))


def series(arms: dict) -> dict:
    """The curves the figure draws, by name, over ``takes``."""
    return {
        "takes": list(arms),
        "val_ce_epoch0": [a["val_ce_epoch0"] for a in arms.values()],
        "val_ce_best": [a["val_ce_best"] for a in arms.values()],
        "truth_mse": [float(np.mean(a["prompted_val_P8"]["truth_mse_by_offset"]))
                      for a in arms.values()],
        "val_nn_floor": [a["val_nn_floor"] for a in arms.values()],
        "recon_floor": [a["recon_floor"] for a in arms.values()],
    }


def draw(s: dict, out: Path) -> Path:
    from ..eval.plots import GRID, INK, INK_2, PALETTE
    from ..utils.optional import pyplot

    plt = pyplot("plot_prior_scaling")
    takes = np.array(s["takes"])
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10.4, 4.0), dpi=140)
    for ax in (ax1, ax2):
        ax.set_xscale("log", base=2)
        ax.set_xticks(takes, [str(t) for t in takes])
        ax.set_xlabel("training takes (log2)", color=INK_2)
        ax.grid(True, color=GRID, linewidth=0.7)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        for side in ("left", "bottom"):
            ax.spines[side].set_color(GRID)
        ax.tick_params(colors=INK_2)

    c_main, c_alt = PALETTE[0], PALETTE[1]
    ax1.plot(takes, s["val_ce_epoch0"], "o--", color=c_alt, lw=2, ms=7, label="epoch 0")
    ax1.plot(takes, s["val_ce_best"], "o-", color=c_main, lw=2, ms=7, label="best epoch")
    ax1.axhline(UNIFORM_CE, color=INK_2, lw=1.2, ls=":")
    ax1.text(takes[0], UNIFORM_CE + 0.08, "uniform (6.37)", color=INK_2, fontsize=8)
    ax1.set_ylabel("grouped-val CE (nats)", color=INK)
    ax1.set_title("generalization onset", color=INK, fontsize=11)
    ax1.legend(frameon=False, fontsize=9, labelcolor=INK_2)

    ax2.plot(takes, s["truth_mse"], "o-", color=c_main, lw=2, ms=7,
             label="generated continuation")
    ax2.plot(takes, s["val_nn_floor"], ":", color=INK_2, lw=1.2)
    ax2.text(takes[-1], s["val_nn_floor"][-1] - 0.028,
             "retrieval floor\n(val nn to train bank)", color=INK_2, fontsize=8, ha="right",
             va="top")
    ax2.plot(takes, s["recon_floor"], ":", color=INK_2, lw=1.2)
    ax2.text(takes[-2], s["recon_floor"][-1] + 0.008, "tokenizer recon floor", color=INK_2,
             fontsize=8, ha="center")
    ax2.set_ylabel("held-out truth-MSE (prompted P=8)", color=INK)
    ax2.set_title("held-out continuation error", color=INK, fontsize=11)
    ax2.legend(frameon=False, fontsize=9, labelcolor=INK_2)

    fig.suptitle("Motion-token prior: corpus scaling (frozen K4 tokenizer, ar_ph4)",
                 color=INK, fontsize=12)
    fig.tight_layout(rect=(0, 0, 1, 0.95))
    out.parent.mkdir(exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    build_parser().parse_args(argv)
    arms = load_arms(REPO)
    if len(arms) < 2:
        print("need >=2 scaling arms in abruns/prior_scale*/scaling.json", file=sys.stderr)
        return 1
    if not have_packages("plot_prior_scaling", "plotting", "matplotlib.pyplot"):
        return 2
    out = draw(series(arms), REPO / "plots" / "prior_scaling.png")
    print(f"[INFO] wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
