"""Sampling-hyperparameter sweep over trained motion-token priors.

    python -m bridgerl_tpu_torch.cli.exp_prior_sampling \
        --ckpt checkpoints/Exp_transformer_W64_K4_hybrid_teacher_seed_42_best.pth \
        --priors abruns/prior_ar/prior_ar.ckpt --temperatures 0.8,0.9,1.0 --top_ks 0,8,32

The flags, defaults, row keys and output file of
``scripts/exp_prior_sampling.py``, the retraining-free follow-on to
``exp_prior_ar``: the teacher and the saved priors are loaded, and
temperature x top_k x top_p x guide (x guide_dyn) points are swept on one
generation protocol (n samples, positions, seed), each scored with the
generation statistics, the overlap disagreement, code novelty and the
nearest data window. Sampling knobs only move where the prior puts its
mass, so the sweep separates bad sampling from a bad prior. A file that
exists at ``--out`` is merged into, the new rows winning.

``--priors`` are the port's prior payloads; samples are the port's
Philox-Gumbel draws from ``--seed`` (top_k 1 is greedy and draws nothing).
``--device`` (default ``cuda``) picks the device; without a card the run
stops unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import cli_device
from ..eval.generation import (
    code_novelty,
    compare_to_data,
    nearest_data_distance,
    overlap_disagreement,
)
from ..eval.studies import RAW_MEAN, RAW_STD, load_priors, load_takes, load_teacher, window_bank
from ..train.prior import extract_code_grids, sample_motion

PROG = "exp_prior_sampling"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="VQ-VAE teacher checkpoint (.pth)")
    p.add_argument("--priors", required=True, help="comma list of prior checkpoints")
    p.add_argument("--data_dir", default="data/dense_w64")
    p.add_argument("--out", default="abruns/prior_ar/sampling_sweep.json")
    p.add_argument("--temperatures", default="0.8,0.9,1.0")
    p.add_argument("--top_ks", default="0,8,32", help="0 = no top-k truncation")
    p.add_argument("--top_ps", default="0",
                   help="0 = no nucleus filtering (composes with top_k)")
    p.add_argument("--guide_dyns", default="0",
                   help="comma list of dynamics-preserving guide weights (needs --guides>=2)")
    p.add_argument("--guides", default="0",
                   help="overlap-consistency guided sampling candidate counts "
                        "(0 = off; e.g. 0,4,16)")
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--positions", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device(PROG, args.device)
    if device is None:
        return 2
    loaded = load_teacher(PROG, args.ckpt, device)
    priors = loaded and load_priors(PROG, args.priors.split(","), device)
    if not priors:
        return 2
    model, exp = loaded
    seqs = load_takes(args.data_dir)
    temps = [float(t) for t in args.temperatures.split(",")]
    top_ks = [int(k) for k in args.top_ks.split(",")]
    top_ps = [float(x) for x in args.top_ps.split(",")]
    guides = [int(x) for x in args.guides.split(",")]
    guide_dyns = [float(x) for x in args.guide_dyns.split(",")]

    sweep = {}
    data_grids = data_mask = data_wins = None
    for name, prior_model, pcfg in priors:
        stride = pcfg.stride
        if data_grids is None:
            # novelty yardsticks: the phase-0 stride grid, the same for every
            # prior trained on this teacher and stride
            data_grids, data_mask, _, _ = extract_code_grids(
                model, exp, seqs, RAW_MEAN, RAW_STD, stride, max_len=pcfg.max_len)
            data_wins = window_bank(seqs, exp.model.window_size, stride)
        grid_points = [(temp, tk, tp, gd, gw)
                       for temp, tk, tp, gd in itertools.product(temps, top_ks, top_ps, guides)
                       for gw in (guide_dyns if gd else [0.0])]
        for temp, tk, tp, gd, gw in grid_points:
            t0 = time.time()
            motions, windows, grid = sample_motion(
                model, exp, prior_model, RAW_MEAN, RAW_STD, n_samples=args.n_samples,
                n_positions=args.positions, temperature=temp, top_k=(tk or None),
                top_p=(tp or None), seed=args.seed, guide_candidates=gd, guide_dyn=gw,
                return_windows=True, return_grid=True)
            rep = compare_to_data(motions, seqs)
            rep["overlap_disagreement"] = float(np.mean(
                [overlap_disagreement(w, stride) for w in windows]))
            rep.update(code_novelty(grid, data_grids, data_mask))
            rep.update(nearest_data_distance(windows, data_wins))
            rep["sample_s"] = round(time.time() - t0, 1)
            key = (f"{name}|T{temp}|k{tk}" + (f"|p{tp}" if tp else "")
                   + (f"|g{gd}" if gd else "") + (f"|d{gw:g}" if gw else ""))
            sweep[key] = rep
            print(f"[{key}] vel {rep['vel_ratio']:.3f} | jerk {rep['jerk_ratio']:.3f} | "
                  f"cov {rep['range_coverage_mean']:.2f} | "
                  f"overlap {rep['overlap_disagreement']:.4f} | "
                  f"novel pos {rep['position_novel_frac']:.2f} "
                  f"bigram {rep['bigram_novel_frac']:.2f} | nn_mse {rep['nn_mse_mean']:.4f}",
                  flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists():   # merge: sweep passes accumulate into one file
        sweep = {**json.loads(out.read_text()), **sweep}
    out.write_text(json.dumps(sweep, indent=1))
    print(f"[INFO] sweep -> {out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
