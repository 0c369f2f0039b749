"""Training curves, an overview and a radar chart from the history JSONs
(``results/log_*.json``) that ``train/trainer.py`` writes.

Counterpart of ``bridgerl_tpu/eval/plots.py`` (the reference's
plot_results.py contract):
- logs are grouped per experiment by splitting the file name on ``_seed_``,
  and twin logs of one run (``log_{id}_seed_{s}`` and
  ``log_{name}_{mode}_seed_{s}`` with the same bytes) count once;
- curves show the cross-seed mean, EMA-smoothed (weight 0.8), with a +-std
  band, on a log y axis for loss and recon metrics;
- the radar min-max normalises last-10-epoch means per axis into
  [0.2, 1.0], higher PPL better and every other metric inverted;
- each registry experiment keeps its hue whatever runs exist.

matplotlib (Agg) is imported by the plotting functions when they run, not
with this module; the aggregation needs only numpy.
"""

from __future__ import annotations

import glob
import hashlib
import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.optional import pyplot

# Validated categorical palette (fixed order; adjacent-pair CVD ΔE >= 8.4,
# normal-vision ΔE >= 19.3). Slots are assigned to entities, never cycled.
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300",
           "#4a3aa7", "#e34948"]
INK = "#0b0b0b"
INK_2 = "#52514e"
GRID = "#d9d8d3"

# Fixed entity->slot mapping for the ablation registry (config.EXPERIMENTS
# order); unknown experiment ids take the remaining slots in first-seen order.
REGISTRY_SLOTS = {
    "simple_ema": 0, "resnet_ema": 1, "resnet_rvq": 2,
    "resnet_fsq": 3, "resnet_lfq": 4, "resnet_hybrid": 5,
}

RADAR_METRICS_MAP = {
    "Recon": "val_recon",
    "Align": "val_align",
    "Smooth": "val_vel",
    "Jerk": "val_jerk",
    "Usage": "dcr",
    "PPL": "perplexity",
}

ALL_METRICS = [
    "val_recon", "val_cross_recon", "val_vel", "val_jerk", "val_align",
    "perplexity", "dcr", "rvq_ppl",
    "train_loss", "train_recon_loss", "train_vq_loss",
]

LOG_SCALE_METRICS = ("loss", "recon")
OVERVIEW_METRICS = ["val_recon", "val_align", "perplexity", "dcr"]


# Non-registry overflow shades (never cycled back into the main palette):
# muted steps that stay distinguishable from the categorical slots.
FALLBACK_SHADES = ["#6b6a66", "#9b7653", "#5d8aa8", "#8f6f9f", "#7a8450"]


def color_for(exp_id: str, seen_order: List[str]) -> str:
    """Stable hue per experiment id: registry ids have fixed slots; other ids
    take the remaining palette slots by first appearance, then muted
    fallback shades (hues are assigned, never cycled)."""
    if exp_id in REGISTRY_SLOTS:
        return PALETTE[REGISTRY_SLOTS[exp_id]]
    free = [PALETTE[i] for i in range(len(PALETTE))
            if i not in REGISTRY_SLOTS.values()] + FALLBACK_SHADES
    others = [e for e in seen_order if e not in REGISTRY_SLOTS]
    return free[others.index(exp_id) % len(free)]


def smooth(scalars, weight: float = 0.8) -> np.ndarray:
    """Running EMA smoothing (semantics shared with the reference exporter)."""
    if len(scalars) == 0:
        return np.array([])
    last = scalars[0]
    out = []
    for p in scalars:
        last = last * weight + p * (1 - weight)
        out.append(last)
    return np.asarray(out)


def load_and_aggregate(
    log_dir: str, filter_str: Optional[str] = None
) -> Dict[str, Dict[str, List[list]]]:
    """Group per-seed logs by experiment id, de-duplicating identical
    histories that exist under two filenames (id-style + mode-style logs of
    the same run). Registry-id filenames win the tie."""
    raw: List[Tuple[str, bool, str, dict]] = []  # (exp_id, mode_style, digest, log)
    for fpath in sorted(glob.glob(os.path.join(log_dir, "log_*.json"))):
        fname = os.path.basename(fpath)
        if filter_str and filter_str not in fname:
            continue
        exp_id = fname.replace("log_", "").replace(".json", "").split("_seed_")[0]
        try:
            with open(fpath) as f:
                body = f.read()
            log = json.loads(body)
        except (OSError, ValueError) as e:
            print(f"Error reading {fname}: {e}")
            continue
        digest = hashlib.sha256(body.encode()).hexdigest()
        # mode-style twin of an id-style log: `log_{name}_{mode}_seed_{s}.json`
        # written next to `log_{id}_seed_{s}.json` for the same run
        mode_style = exp_id.endswith(("_teacher", "_student"))
        raw.append((exp_id, mode_style, digest, log))

    id_digests = {digest for _, mode_style, digest, _ in raw if not mode_style}
    data: Dict[str, Dict[str, List[list]]] = {}
    for exp_id, mode_style, digest, log in raw:
        if mode_style and digest in id_digests:
            continue  # same run already aggregated under its id-style name
        bucket = data.setdefault(exp_id, {})
        for metric in ALL_METRICS:
            if metric in log and len(log[metric]) > 0:
                bucket.setdefault(metric, []).append(log[metric])
    return data


def _style_axis(ax, logscale: bool = False):
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    ax.spines["left"].set_color(GRID)
    ax.spines["bottom"].set_color(GRID)
    ax.tick_params(colors=INK_2, labelsize=8)
    ax.grid(True, axis="y", color=GRID, linewidth=0.6, alpha=0.6)
    ax.set_axisbelow(True)
    if logscale:
        ax.set_yscale("log")


def _draw_metric(ax, data, metric_key: str, seen_order: List[str]) -> bool:
    has_data = False
    for exp_id in seen_order:
        metrics = data[exp_id]
        if metric_key not in metrics:
            continue
        runs = metrics[metric_key]
        min_len = min(len(x) for x in runs)
        if min_len < 2:
            continue
        arr = np.asarray([x[:min_len] for x in runs])
        mean_s = smooth(arr.mean(axis=0))
        std = arr.std(axis=0)
        epochs = np.arange(1, min_len + 1)
        c = color_for(exp_id, seen_order)
        ax.plot(epochs, mean_s, color=c, linewidth=2.0,
                label=exp_id.replace("_", " "), solid_capstyle="round")
        ax.fill_between(epochs, mean_s - std, mean_s + std, color=c,
                        alpha=0.12, linewidth=0)
        has_data = True
    return has_data


def plot_metric_curve(data, metric_key: str, save_dir: str) -> Optional[str]:
    plt = pyplot()
    seen_order = list(data.keys())
    fig, ax = plt.subplots(figsize=(7.5, 4.5))
    if not _draw_metric(ax, data, metric_key, seen_order):
        plt.close(fig)
        return None
    _style_axis(ax, logscale=any(k in metric_key for k in LOG_SCALE_METRICS))
    ax.set_xlabel("epoch", color=INK_2, fontsize=9)
    ax.set_ylabel(metric_key.replace("_", " "), color=INK_2, fontsize=9)
    ax.set_title(metric_key.replace("_", " "), color=INK, fontsize=11,
                 loc="left", fontweight="semibold")
    ax.legend(frameon=False, fontsize=8, labelcolor=INK_2)
    fig.tight_layout()
    path = os.path.join(save_dir, f"compare_{metric_key}.png")
    fig.savefig(path, dpi=160)
    plt.close(fig)
    return path


def plot_overview(data, save_dir: str) -> Optional[str]:
    """Small-multiples headline figure: one panel per key metric, shared
    entity hues, single legend."""
    plt = pyplot()
    seen_order = list(data.keys())
    avail = [m for m in OVERVIEW_METRICS
             if any(m in data[e] for e in seen_order)]
    if not avail:
        return None
    n = len(avail)
    cols = min(n, 2)
    rows = math.ceil(n / cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5.2 * cols, 3.2 * rows),
                             squeeze=False)
    drawn = False
    for k, m in enumerate(avail):
        ax = axes[k // cols][k % cols]
        if _draw_metric(ax, data, m, seen_order):
            drawn = True
        _style_axis(ax, logscale=any(s in m for s in LOG_SCALE_METRICS))
        ax.set_title(m.replace("_", " "), color=INK, fontsize=10, loc="left")
    for k in range(len(avail), rows * cols):
        axes[k // cols][k % cols].axis("off")
    if not drawn:
        plt.close(fig)
        return None
    handles, labels = axes[0][0].get_legend_handles_labels()
    if not handles:
        for row in axes:
            for ax in row:
                handles, labels = ax.get_legend_handles_labels()
                if handles:
                    break
            if handles:
                break
    fig.legend(handles, labels, frameon=False, fontsize=8, labelcolor=INK_2,
               loc="lower center", ncol=min(len(labels), 6),
               bbox_to_anchor=(0.5, -0.01))
    fig.suptitle("Training overview (mean ± std across seeds)", color=INK,
                 fontsize=12, x=0.02, ha="left")
    fig.tight_layout(rect=(0, 0.04, 1, 0.96))
    path = os.path.join(save_dir, "overview.png")
    fig.savefig(path, dpi=160)
    plt.close(fig)
    return path


def radar_scores(data) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """Per-experiment normalized radar scores (contract semantics: last-10-
    epoch means, min-max into [0.2, 1.0] per axis, PPL higher-better, all
    other axes inverted)."""
    categories = list(RADAR_METRICS_MAP.keys())
    summary = {}
    for exp_id, metrics in data.items():
        vals = []
        for key in RADAR_METRICS_MAP.values():
            if key in metrics:
                vals.append(float(np.mean([np.mean(s[-10:]) for s in metrics[key]])))
            else:
                vals.append(0.0)
        summary[exp_id] = vals
    if not summary:
        return categories, {}
    arr = np.asarray(list(summary.values()))
    scores = np.ones_like(arr)
    for i, cat in enumerate(categories):
        col = arr[:, i]
        if col.max() > col.min():
            frac = (col - col.min()) / (col.max() - col.min())
            scores[:, i] = 0.2 + 0.8 * (frac if cat == "PPL" else 1.0 - frac)
    return categories, {e: scores[k] for k, e in enumerate(summary)}


def plot_radar_chart(data, save_dir: str) -> Optional[str]:
    plt = pyplot()
    categories, scores = radar_scores(data)
    if not scores:
        return None
    seen_order = list(data.keys())
    N = len(categories)
    angles = [k / N * 2 * math.pi for k in range(N)] + [0.0]

    fig = plt.figure(figsize=(6.5, 7.0))
    ax = fig.add_subplot(111, polar=True)
    ax.set_facecolor("white")
    for exp_id, vals in scores.items():
        c = color_for(exp_id, seen_order)
        closed = vals.tolist() + [vals[0]]
        ax.plot(angles, closed, color=c, linewidth=2.0,
                label=exp_id.replace("_", " "))
        ax.fill(angles, closed, color=c, alpha=0.10)
    ax.set_xticks(angles[:-1])
    ax.set_xticklabels(categories, color=INK_2, fontsize=9)
    ax.set_yticks([0.2, 0.6, 1.0])
    ax.set_yticklabels([])
    ax.set_ylim(0, 1.05)
    ax.grid(color=GRID, linewidth=0.6)
    ax.spines["polar"].set_color(GRID)
    ax.set_title("Relative performance per axis (outer = better)",
                 color=INK, fontsize=11, pad=18)
    ax.legend(frameon=False, fontsize=8, labelcolor=INK_2,
              loc="upper center", bbox_to_anchor=(0.5, -0.06),
              ncol=min(len(scores), 3))
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "radar_chart.png")
    fig.savefig(path, dpi=160, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_all(log_dir: str = "results", out_dir: str = "plots/metrics",
             filter_str: Optional[str] = None) -> List[str]:
    """Every curve, the overview and the radar chart (one directory up from
    ``out_dir``); the paths written."""
    pyplot()
    os.makedirs(out_dir, exist_ok=True)
    data = load_and_aggregate(log_dir, filter_str)
    if not data:
        return []
    written = []
    for m in ALL_METRICS:
        p = plot_metric_curve(data, m, out_dir)
        if p:
            written.append(p)
    for fn, where in ((plot_overview, out_dir),
                      (plot_radar_chart, os.path.dirname(out_dir) or ".")):
        p = fn(data, where)
        if p:
            written.append(p)
    return written
