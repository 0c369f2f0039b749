"""Generation-quality statistics: do sampled motions look like the data?

The port's own numpy copy of ``bridgerl_tpu/eval/generation.py`` (the same
functions, the same numbers). It compares low-order motion statistics of
generated joint trajectories with the training data's:

- per-frame joint velocity and jerk RMS (first and third differences)
- per-joint position range coverage (the share of the data's min-max span
  the samples visit: a prior stuck on one token covers almost none)
- the static-pose share (frames with about zero velocity)

and scores sampling coherence (``overlap_disagreement``), novelty in code
space (``code_novelty``) and in motion space (``nearest_data_distance``),
class conditioning (``slot_histograms``, ``class_histogram_match``) and
prompted continuation (``continuation_curves``). Everything is numpy over
raw (T, D) trajectories, windows or grids.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def motion_stats(motions: Sequence[np.ndarray],
                 eps: float = 1e-4) -> Dict[str, float]:
    """Aggregate motion statistics over a list of raw (T, D) trajectories."""
    vels, jerks, static = [], [], []
    lo = np.full(motions[0].shape[1], np.inf)
    hi = np.full(motions[0].shape[1], -np.inf)
    for m in motions:
        m = np.asarray(m, np.float32)
        v = np.diff(m, axis=0)
        j = np.diff(m, n=3, axis=0) if m.shape[0] > 3 else np.zeros_like(v[:0])
        vels.append(np.sqrt(np.mean(v ** 2)))
        if j.size:
            jerks.append(np.sqrt(np.mean(j ** 2)))
        static.append(float(np.mean(np.abs(v).max(axis=1) < eps)))
        lo = np.minimum(lo, m.min(axis=0))
        hi = np.maximum(hi, m.max(axis=0))
    return {
        "vel_rms": float(np.mean(vels)),
        "jerk_rms": float(np.mean(jerks)) if jerks else 0.0,
        "static_frac": float(np.mean(static)),
        "joint_lo": lo,
        "joint_hi": hi,
    }


def compare_to_data(generated: Sequence[np.ndarray],
                    reference: Sequence[np.ndarray]) -> Dict[str, float]:
    """Generated-vs-data report. Ratios near 1.0 = statistics match; range
    coverage in [0, 1] = how much of the data's per-joint span samples visit."""
    g, r = motion_stats(generated), motion_stats(reference)
    span = np.maximum(r["joint_hi"] - r["joint_lo"], 1e-6)
    overlap_lo = np.maximum(g["joint_lo"], r["joint_lo"])
    overlap_hi = np.minimum(g["joint_hi"], r["joint_hi"])
    coverage = np.clip((overlap_hi - overlap_lo) / span, 0.0, 1.0)
    return {
        "vel_rms_gen": g["vel_rms"],
        "vel_rms_data": r["vel_rms"],
        "vel_ratio": g["vel_rms"] / max(r["vel_rms"], 1e-9),
        "jerk_rms_gen": g["jerk_rms"],
        "jerk_rms_data": r["jerk_rms"],
        "jerk_ratio": g["jerk_rms"] / max(r["jerk_rms"], 1e-9),
        "static_frac_gen": g["static_frac"],
        "static_frac_data": r["static_frac"],
        "range_coverage_mean": float(np.mean(coverage)),
        "range_coverage_min": float(np.min(coverage)),
    }


def overlap_disagreement(windows: np.ndarray, stride: int) -> float:
    """RMS disagreement of adjacent sampled windows on their overlap region.

    ``windows`` is (N, W, D) — consecutive decoded windows placed on the pure
    stride grid, BEFORE overlap-add stitching. Ground-truth windows of one
    take agree exactly on their overlap (RMS 0); a prior whose adjacent
    positions describe different motions disagrees, and the stitch averages
    the disagreement away into under-dynamic output (docs/ROUND3.md). This is
    the direct measure of that coherence failure. Returns 0.0 when stride >=
    W (no overlap).
    """
    N, W, _ = windows.shape
    ov = W - stride
    if ov <= 0 or N < 2:
        return 0.0
    a = windows[:-1, stride:]      # tail of window i on the shared frames
    b = windows[1:, :ov]           # head of window i+1 on the same frames
    return float(np.sqrt(np.mean((a - b) ** 2)))


def code_novelty(gen_grids: np.ndarray, data_grids: np.ndarray,
                 data_mask: np.ndarray | None = None) -> Dict[str, float]:
    """Memorize-vs-recombine detector in code space.

    A prior selected on TRAIN CE (PriorTrainConfig.select="train") is allowed
    to fit a memorization-scale corpus; these fractions say what it does with
    that fit when sampling. ``gen_grids`` (B, N, S) int32 sampled grids,
    ``data_grids`` (M, L, S) the training grids with optional (M, L) mask.

    - position_novel_frac: fraction of sampled positions whose full S-token
      tuple never occurs in the data (0 = every sampled window is a data
      window; high = decoding windows the tokenizer never produced).
    - bigram_novel_frac: fraction of adjacent sampled position PAIRS not
      occurring adjacently in the data. The recombination signal: novel
      bigrams over known positions = stitching familiar windows into new
      motion; bigram novelty ~ position novelty = no real recombination.
    """
    def _tuples(grids, mask):
        out = []
        for i in range(grids.shape[0]):
            n = int(mask[i].sum()) if mask is not None else grids.shape[1]
            out.append([tuple(int(t) for t in grids[i, j])
                        for j in range(n)])
        return out

    data_rows = _tuples(np.asarray(data_grids), data_mask)
    data_pos = set(t for row in data_rows for t in row)
    data_bi = set((row[j], row[j + 1]) for row in data_rows
                  for j in range(len(row) - 1))
    gen_rows = _tuples(np.asarray(gen_grids), None)
    n_pos = sum(len(r) for r in gen_rows)
    n_bi = sum(max(len(r) - 1, 0) for r in gen_rows)
    novel_pos = sum(t not in data_pos for r in gen_rows for t in r)
    novel_bi = sum((r[j], r[j + 1]) not in data_bi
                   for r in gen_rows for j in range(len(r) - 1))
    return {
        "position_novel_frac": novel_pos / max(n_pos, 1),
        "bigram_novel_frac": novel_bi / max(n_bi, 1),
    }


def slot_histograms(grids: np.ndarray, mask: np.ndarray | None,
                    vocab_sizes) -> np.ndarray:
    """Per-slot token frequency vectors, concatenated and L1-normalized
    per slot: (sum(vocab_sizes),). The code-space signature of a motion
    distribution — what the class-conditioned prior is supposed to move.
    """
    grids = np.asarray(grids)
    S = grids.shape[-1]
    if S != len(vocab_sizes):
        raise ValueError(f"grids have {S} slots, vocab_sizes has "
                         f"{len(vocab_sizes)}")
    flat = grids.reshape(-1, S)
    if mask is not None:
        keep = np.asarray(mask, bool).reshape(-1)
        flat = flat[keep]
    parts = []
    for s, v in enumerate(vocab_sizes):
        h = np.bincount(flat[:, s], minlength=v).astype(np.float64)
        parts.append(h / max(h.sum(), 1.0))
    return np.concatenate(parts)


def class_histogram_match(gen_grids: np.ndarray, gen_class_ids: np.ndarray,
                          data_grids: np.ndarray, data_class_ids: np.ndarray,
                          vocab_sizes,
                          data_mask: np.ndarray | None = None) -> Dict:
    """Does conditioned sampling move the CODE distribution per class?

    Nearest-classes each sampled class's token histogram against the
    per-class histograms of the (train) data, by total-variation distance —
    the committed version of the round-3 "4/7 exact code-space match" readout
    (motion space is confounded by decode smoothing, docs/ROUND3.md).
    ``gen_grids`` (B, N, S) with ``gen_class_ids`` (B,); data side likewise
    grouped by ``data_class_ids`` with optional (M, L) mask. Returns
    accuracy over the sampled classes, the per-class prediction, and the
    margin (runner-up distance minus winner — 0 means a coin flip).
    """
    gen_class_ids = np.asarray(gen_class_ids)
    data_class_ids = np.asarray(data_class_ids)
    data_hists = {}
    for c in np.unique(data_class_ids):
        rows = data_class_ids == c
        data_hists[int(c)] = slot_histograms(
            np.asarray(data_grids)[rows],
            None if data_mask is None else np.asarray(data_mask)[rows],
            vocab_sizes)
    classes = sorted(data_hists)
    predicted, margins = {}, {}
    for c in np.unique(gen_class_ids):
        h = slot_histograms(np.asarray(gen_grids)[gen_class_ids == c],
                            None, vocab_sizes)
        dists = np.asarray([0.5 * np.abs(h - data_hists[k]).sum()
                            for k in classes])
        order = np.argsort(dists)
        predicted[int(c)] = int(classes[order[0]])
        margins[int(c)] = float(dists[order[1]] - dists[order[0]]) \
            if len(classes) > 1 else 0.0
    hits = sum(predicted[c] == c for c in predicted)
    return {
        "accuracy": hits / max(len(predicted), 1),
        "n_classes": len(predicted),
        "predicted": predicted,
        "margins": margins,
    }


def nearest_data_distance(gen_windows: np.ndarray,
                          data_windows: np.ndarray,
                          chunk: int = 2048) -> Dict[str, float]:
    """Motion-space novelty: per sampled window, MSE to its nearest data
    window (both (…, W, D), flattened per window). 0 = verbatim copy of a
    data window; the data's own scale is the per-window variance. Returns the
    mean/min/max over all sampled windows.
    """
    g = np.asarray(gen_windows, np.float32).reshape(-1, np.prod(gen_windows.shape[-2:]))
    d = np.asarray(data_windows, np.float32).reshape(-1, g.shape[1])
    g2 = np.sum(g ** 2, axis=1)[:, None]
    best = np.full(g.shape[0], np.inf, np.float32)
    for i in range(0, d.shape[0], chunk):
        dc = d[i:i + chunk]
        # ||g - d||^2 = g2 - 2 g.d + d2, per pair
        dist = g2 - 2.0 * g @ dc.T + np.sum(dc ** 2, axis=1)[None, :]
        best = np.minimum(best, dist.min(axis=1))
    best = np.maximum(best, 0.0) / g.shape[1]   # -> per-element MSE
    return {
        "nn_mse_mean": float(best.mean()),
        "nn_mse_min": float(best.min()),
        "nn_mse_max": float(best.max()),
    }


def continuation_curves(cont_windows: np.ndarray,
                        true_windows: np.ndarray,
                        data_windows: np.ndarray,
                        offsets: Sequence[int] = (0, 1, 2, 3, 7, 15, 31),
                        ) -> Dict[str, list]:
    """Per-offset error-compounding curves for prompted continuation.

    ``cont_windows`` (n, N, W, D) are the generated continuation windows
    (position >= prompt length), ``true_windows`` the take's TRUE
    continuation decoded through the same tokenizer (aligned shapes), and
    ``data_windows`` the nearest-neighbour bank. Returns, per probed offset:
    nn_mse (distance to the data manifold — does the rollout stay
    on-distribution?) and truth_mse (divergence from the real take — small at
    offset 0 + growing = anchored-but-novel; flat-high = never anchored;
    ~0 everywhere = verbatim copy). The final offset is always probed.
    """
    cont = np.asarray(cont_windows, np.float32)
    true = np.asarray(true_windows, np.float32)
    if cont.shape != true.shape:
        raise ValueError(f"cont {cont.shape} != true {true.shape}")
    n_off = cont.shape[1]
    probe = sorted(({int(o) for o in offsets} | {n_off - 1}) &
                   set(range(n_off)))
    return {
        "offsets": probe,
        "nn_mse_by_offset": [
            nearest_data_distance(cont[:, j], data_windows)["nn_mse_mean"]
            for j in probe],
        "truth_mse_by_offset": [
            float(np.mean((cont[:, j] - true[:, j]) ** 2)) for j in probe],
    }


def format_report(rep: Dict[str, float]) -> str:
    lines = [
        "generation vs data statistics:",
        f"  vel RMS   gen {rep['vel_rms_gen']:.5f} | data "
        f"{rep['vel_rms_data']:.5f} | ratio {rep['vel_ratio']:.2f}",
        f"  jerk RMS  gen {rep['jerk_rms_gen']:.5f} | data "
        f"{rep['jerk_rms_data']:.5f} | ratio {rep['jerk_ratio']:.2f}",
        f"  static fraction  gen {rep['static_frac_gen']:.3f} | data "
        f"{rep['static_frac_data']:.3f}",
        f"  joint range coverage  mean {rep['range_coverage_mean']:.2f} | "
        f"min {rep['range_coverage_min']:.2f}",
    ]
    return "\n".join(lines)
